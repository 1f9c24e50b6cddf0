"""The port's sharding rule table (``repro_torch.sharding``) and production
meshes (``repro_torch.mesh``) against the reference's ``repro.dist.sharding``.

Pure shape arithmetic, no compile: both rule tables read stand-in meshes
(the reference's ``FakeMesh`` form, ``axis_names`` and ``devices.shape``;
the port's, ``mesh_dim_names`` and ``shape``).  Placements must be equal
exactly, leaf for leaf, for every one of the ten configs' parameters (with
and without ``opt_data_axis``) and decode caches on the meshes (16, 16),
(32, 8) and (2, 16, 16); the bytes a device holds of parameters, optimizer
state and caches must be equal exactly too.  The port's caches are one dict
a layer where the reference stacks them over layer groups: a stacked
leaf's placement is the port's with the layer dimension in front (never
sharded).  The fake process group opens only in a subprocess.
"""
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import get_config as rget
from repro.dist import sharding as RSH
from repro.models import spec as RS
from repro.models import transformer as RT
from repro_torch import mesh as TM
from repro_torch import sharding as SH
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs
from repro_torch.models import spec as TS
from repro_torch.models import transformer as TT

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = list_archs()
MESHES = [((16, 16), ("data", "model")), ((32, 8), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _ref_mesh(shape, names):
    return types.SimpleNamespace(axis_names=names,
                                 devices=types.SimpleNamespace(shape=shape, size=0))


def _port_mesh(shape, names):
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape)


def _ps(shape, logical, **kw):
    return SH.spec_pspec(TS.ParamSpec(shape, logical), _port_mesh((16, 16), ("data", "model")), **kw)


# -- the reference's five cases (tests/test_sharding.py) ----------------------

def test_divisible_dims_shard():
    assert _ps((5120, 25600), ("embed", "mlp")) == (None, "model")
    assert _ps((202240, 5120), ("vocab", "embed")) == ("model", None)
    assert _ps((5120, 64, 128), ("embed", "heads", None)) == (None, "model", None)


def test_indivisible_falls_back():
    assert _ps((576, 9, 64), ("embed", "heads", None)) == ("model", None, None)
    assert _ps((7, 9), ("heads", "kv")) == (None, None)


def test_expert_priority_over_mlp():
    assert _ps((128, 5120, 8192), ("experts", "embed", "mlp")) == ("model", None, None)
    assert _ps((8, 6144, 32768), ("experts", "embed", "mlp")) == (None, None, "model")


def test_opt_data_axis_zero_style():
    assert _ps((5120, 25600), ("embed", "mlp"), opt_data_axis="data") == ("data", "model")


def test_layers_axis_never_sharded():
    assert _ps((16, 5120, 25600), ("layers", "embed", "mlp"), opt_data_axis="data")[0] is None


# -- every leaf of every config ----------------------------------------------

def _ref_leaves(tree, prefix=""):
    if RS.is_spec(tree):
        return [(prefix, tree)]
    return [p for k in sorted(tree) for p in _ref_leaves(tree[k], f"{prefix}/{k}")]


def _pairs(ptree, rtree, prefix=""):
    """(path, port leaf, reference leaf) over two dict trees of equal keys."""
    if isinstance(ptree, dict):
        assert sorted(ptree) == sorted(rtree), prefix
        return [p for k in sorted(ptree) for p in _pairs(ptree[k], rtree[k], f"{prefix}/{k}")]
    return [(prefix, ptree, rtree)]


def _ref_bytes(abs_tree, ps_tree, mesh) -> int:
    total = 0
    for x, ps in zip(jax.tree.leaves(abs_tree),
                     jax.tree.leaves(ps_tree, is_leaf=lambda p: isinstance(p, jax.sharding.PartitionSpec))):
        n = 1
        for d, e in zip(x.shape, tuple(ps) + (None,) * (len(x.shape) - len(ps))):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            k = 1
            for a in axes:
                k *= RSH.mesh_axis_size(mesh, a)
            n *= d // k
        total += n * x.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_param_placements_and_bytes_equal_the_reference(arch):
    rcfg, tcfg = rget(arch), tget(arch)
    rspecs = RT.param_specs(rcfg)
    tspecs = TT.param_specs(tcfg)
    for shape, names in MESHES:
        rm, tm = _ref_mesh(shape, names), _port_mesh(shape, names)
        for opt in (None, "data"):
            rps = RSH.param_pspecs(rspecs, rm, opt_data_axis=opt)
            tps = SH.param_pspecs(tspecs, tm, opt_data_axis=opt)
            for path, t, r in _pairs(tps, rps):
                assert t == tuple(r), (arch, shape, opt, path, t, r)
            rb = _ref_bytes(RS.abstract_params(rspecs), rps, rm)
            assert SH.per_device_bytes(TS.abstract_params(tspecs), tps, tm) == rb
            assert SH.per_device_bytes(tspecs, tps, tm) == rb   # ParamSpec leaves too


def _ref_dryrun():
    """The reference's dry-run module, imported with jax's device count
    already fixed (the module sets XLA_FLAGS for 512 fake devices at import;
    the variable is put back at once)."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as RD
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return RD


@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_state_bytes_equal_the_reference(arch):
    from repro_torch import dryrun as TD

    RD = _ref_dryrun()
    rcfg, tcfg = rget(arch), tget(arch)
    rspecs, tspecs = RT.param_specs(rcfg), TT.param_specs(tcfg)
    for shape, names in MESHES:
        rm, tm = _ref_mesh(shape, names), _port_mesh(shape, names)
        r_abs, r_ps = RD._opt_abstract_and_pspecs(rcfg, RS.abstract_params(rspecs), rspecs, rm)
        t_abs, t_ps = TD.opt_abstract_and_pspecs(tcfg, TS.abstract_params(tspecs), tspecs, tm)
        assert SH.per_device_bytes(t_abs, t_ps, tm) == _ref_bytes(r_abs, r_ps, rm), (arch, shape)
        for f in type(t_abs)._fields[1:]:   # leaf for leaf, past the step
            for path, t, r in _pairs(getattr(t_ps, f), getattr(r_ps, f)):
                assert t == tuple(r), (arch, shape, f, path)


def _port_layer_of(cfg, group: str, i: int):
    """The port's layer index of the reference's stacked ``b{j}`` slice i
    or tail ``t{j}``."""
    pat = len(cfg.block_pattern)
    n_groups = cfg.num_layers // pat
    kind, j = group[0], int(group[1:])
    return i * pat + j if kind == "b" else n_groups * pat + j


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_placements_and_bytes_equal_the_reference(arch):
    """Decode caches at the decode cells' (batch, seq): decode_32k and, for
    the sub-quadratic archs, long_500k."""
    from repro_torch.shapes import SHAPES, cell_runnable

    rcfg, tcfg = rget(arch), tget(arch)
    for cell in ("decode_32k", "long_500k"):
        if not cell_runnable(tcfg, cell)[0]:
            continue
        B, S = SHAPES[cell]["batch"], SHAPES[cell]["seq"]
        r_abs = jax.eval_shape(lambda: RT.init_cache(rcfg, B, S))
        t_abs = TT.abstract_cache(tcfg, B, S)
        for shape, names in MESHES:
            rm, tm = _ref_mesh(shape, names), _port_mesh(shape, names)
            r_ps = RSH.cache_pspecs(r_abs, rm, batch=B, seq_len=S)
            t_ps = SH.cache_pspecs(t_abs, tm, batch=B, seq_len=S)
            for part in ("layers", "tail"):
                for g, leaves in r_ps[part].items():
                    for k, ps in leaves.items():
                        stacked = part == "layers"
                        n = r_abs[part][g][k].shape[0] if stacked else 1
                        for i in range(n):
                            t = t_ps[_port_layer_of(tcfg, g, i)][k]
                            want = tuple(ps)[1:] if stacked else tuple(ps)
                            want += (None,) * (len(t) - len(want))
                            if stacked:
                                assert tuple(ps)[:1] in ((), (None,)), (arch, g, k, ps)
                            assert t == want, (arch, cell, shape, g, k, i, t, ps)
            assert SH.per_device_bytes(t_abs, t_ps, tm) == _ref_bytes(r_abs, r_ps, rm)


def test_abstract_trees_allocate_nothing_and_init_still_refuses_meta():
    cfg = tget("smollm_135m")
    params = TS.abstract_params(TT.param_specs(cfg))
    cache = TT.abstract_cache(cfg, 4, 128)
    for t in [params["embed"], cache[0]["k"]]:
        assert t.device.type == "meta"
    assert params["embed"].dtype == torch.bfloat16 and cache[0]["k"].shape == (4, 128, 3, 64)
    gen = torch.Generator()
    with pytest.raises(ValueError, match="unsupported device"):
        TS.init_params(TT.param_specs(cfg.smoke()), gen, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TT.init_cache(cfg.smoke(), 1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TT.init_model(cfg.smoke(), device="meta")


def test_ambient_mesh_is_none_and_placements_follow_the_mesh_axes():
    from torch.distributed.tensor import Replicate, Shard

    assert SH.ambient_mesh() is None
    tm = _port_mesh((2, 32, 8), ("pod", "data", "model"))
    assert SH.batch_axes(tm) == ("pod", "data")
    assert SH.to_placements((("pod", "data"), None, "model"), tm) == [Shard(0), Shard(0), Shard(2)]
    assert SH.to_placements((None, None), tm) == [Replicate()] * 3


def test_h100_constants():
    assert (TM.PEAK_FLOPS_BF16, TM.HBM_BW, TM.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert TM.HBM_PER_CHIP == 80 * 10**9


def test_production_meshes_on_the_fake_group_in_a_subprocess():
    code = textwrap.dedent("""
        import sys; sys.path.insert(0, %r)
        import torch.distributed as dist
        from repro_torch import mesh as M, sharding as SH
        m = M.make_production_mesh()
        assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (32, 8)
        assert dist.get_backend() == "fake" and dist.get_world_size() == 256
        m2 = M.make_production_mesh(multi_pod=True)
        assert m2.mesh_dim_names == ("pod", "data", "model") and tuple(m2.shape) == (2, 32, 8)
        assert dist.get_world_size() == 512 and SH.mesh_axis_size(m2, "data") == 32
        t = M.make_test_mesh(8, ("data", "model"))
        assert tuple(t.shape) == (4, 2)
        print("OK")
    """ % str(SRC))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK" in r.stdout


def test_fake_meshes_refuse_a_real_group_in_a_subprocess(tmp_path):
    code = textwrap.dedent("""
        import sys; sys.path.insert(0, %r)
        import torch.distributed as dist
        from repro_torch import mesh as M
        dist.init_process_group("gloo", init_method="file://%s", rank=0, world_size=1)
        try:
            M.make_production_mesh()
        except RuntimeError as e:
            assert "real process group" in str(e)
            print("OK")
        dist.destroy_process_group()
    """ % (str(SRC), str(tmp_path / "store")))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK" in r.stdout
