"""Production meshes and the H100's roofline constants.

Port of ``repro/launch/mesh.py``, for an H100 fleet in place of TPU v5e
pods.  :func:`make_production_mesh` is a function (not a module-level
constant) so that importing this module opens no process group.

Topology: nodes of eight H100 SXM cards joined all to all by NVLink.
Single: 256 cards as ``(data=32, model=8)``: the ``model`` axis is one
node's eight cards, so tensor parallelism never leaves NVLink.  Multi: 512
cards as ``(pod=2, data=32, model=8)``: gradient reductions cross the
inter-node network on ``pod``.

The meshes are built over PyTorch's fake process group
(``torch.testing._internal.distributed.fake_pg``): rank 0's view of a
world of that size, with no peers and no device, which is all the dry run
(``repro_torch.dryrun``) reads — the sharding rule table needs only
``mesh_dim_names`` and ``shape``.  Opening it makes it the process's
default group, so build a mesh in a process of its own (the dry run's
cells each run in a subprocess), never beside a real group.
"""
from __future__ import annotations

import math

# H100 SXM per-card constants (roofline denominators)
PEAK_FLOPS_BF16 = 989e12      # FLOP/s: the H100 SXM datasheet's dense bf16 tensor-core peak
HBM_BW = 3.35e12              # B/s: the H100 SXM datasheet's HBM3 bandwidth
NVLINK_BW = 450e9             # B/s each way: the H100 SXM datasheet's NVLink (900 GB/s both ways)
HBM_PER_CHIP = 80 * 10**9     # bytes: the H100 SXM datasheet's 80 GB of HBM3

PRODUCTION = {"single": ((32, 8), ("data", "model")),
              "multi": ((2, 32, 8), ("pod", "data", "model"))}


def fake_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over the fake process
    group, as rank 0 of a world of ``prod(shape)``.  Opens that group as the
    default one if none is open; refuses any other open group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is open: build fake meshes in a "
                               "process of their own")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    shape, names = PRODUCTION["multi" if multi_pod else "single"]
    return fake_mesh(shape, names)


def make_test_mesh(devices: int = 8, axes=("data",)):
    """Small mesh of ``devices`` fake ranks: ``(devices,)`` on one axis, or
    ``(devices // 2, 2)`` on two (the reference's test mesh over fake XLA
    devices)."""
    shape = (devices,) if len(axes) == 1 else (devices // 2, 2)
    return fake_mesh(shape, axes)
