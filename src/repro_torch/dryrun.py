"""Dry run: every (arch × shape × mesh) cell's memory, operations, bytes and
collective traffic a device, on the ``meta`` device — no card, no memory.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell on 512 fake XLA devices and reads XLA's memory and cost analyses.  The
port compiles nothing; for each cell it

  * builds the step on ``meta`` tensors (:func:`build_cell`: parameters from
    ``models.spec.abstract_params``, the optimizer state from ``opt_init``
    on them, the batch and cache from ``repro_torch.shapes``) and places
    every argument by the sharding rule table (``repro_torch.sharding``);
  * sums the arguments' and outputs' bytes a device holds under those
    placements (``memory``; a donated argument — the train step's parameters
    and optimizer state, the decode step's cache, all updated in place — is
    counted once, as the reference's ``alias_bytes``);
  * runs the step once on ``meta`` at one device's batch (the global batch
    over the data axes' product) and full width, under
    ``repro_torch.cost.CostCounter`` (loop-scaled, with memory): the flops
    and bytes it dispatches over the ``model`` axis's size are
    ``flops_per_device``/``bytes_per_device``, and the peak of the live
    bytes it allocates, less its new outputs, is ``temp_bytes``, with an
    allocation of a parameter's shape (a gradient, an accumulator) counted
    at that parameter's shard (:func:`param_shards`) and what the trips the
    count leaves out would hold counted for them (``repro_torch.cost``) —
    exact for the data axes, an upper bound for what the model axis would
    shard of the activations (the JSON's ``notes`` say so);
  * models the collective bytes a device receives (``collective_bytes_per_device``):
    see :func:`collective_model`.

XLA's ``*_loopsonce`` cost-analysis keys and ``collective_bytes_unscaled``
(collectives read from compiled text) have no counterpart: nothing is
compiled.

    python -m repro_torch.dryrun --arch qwen3_32b --shape train_4k --mesh single
    python -m repro_torch.dryrun --all --mesh multi --jobs 8   # every cell
    python -m repro_torch.dryrun --all --smoke --out /tmp/dry   # smoke configs

Per-cell JSON lands in ``experiments/dryrun/`` (``--out`` elsewhere).  A
cell runs in a process of its own (``--all`` spawns one per cell, ``--jobs``
at a time): the production mesh opens PyTorch's fake process group there
(``repro_torch.mesh``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch import sharding as SH
from repro_torch.configs import get_config, list_archs
from repro_torch.shapes import SHAPES, batch_specs, cell_runnable, decode_specs

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "experiments" / "dryrun"

NOTES = ("flops_per_device and bytes_per_device: counted on meta at one device's batch and "
         "full width, divided by the model axis's size (tensor parallelism assumed to split "
         "the work evenly); temp_bytes: the peak of the live bytes the step allocates at one "
         "device's batch and full width, less its outputs, with parameter-shaped allocations "
         "(gradients, accumulators) at their rule-table shard, and what the trips a "
         "loop-scaled count leaves out would hold (checkpointed carries, saved tensors) "
         "counted for them — exact for the data axes, an upper bound for what the model "
         "axis would shard of the activations; "
         "collective_bytes_per_device: a model from the rule table, not a measurement "
         "(repro_torch.dryrun.collective_model)")


@dataclasses.dataclass
class Cell:
    """One cell's step on ``meta``: ``step(*setup())`` steps once at one
    device's batch (``setup`` builds the arguments: the parameters at full
    width, the batch and cache at ``local_batch``); ``args`` are the global
    abstract arguments, ``pspecs`` their placements, ``donate`` the ones
    the step updates in place; ``out_abs``/``out_pspecs`` the step's
    outputs and their placements."""
    cfg: object
    kind: str
    setup: object
    step: object
    args: tuple
    pspecs: tuple
    donate: tuple
    out_abs: tuple
    out_pspecs: tuple
    batch: int
    local_batch: int
    seq: int
    microbatches: int
    spec_tree: dict


def data_size(mesh) -> int:
    return math.prod(SH.mesh_axis_size(mesh, a) for a in SH.batch_axes(mesh))


def _generic(mesh):
    """The reference's placement of a factored optimizer statistic: on each
    of ``model`` then ``data``, the largest remaining dimension it divides."""
    def one(x):
        assign = [None] * len(x.shape)
        for axis in ("model", "data"):
            size = SH.mesh_axis_size(mesh, axis)
            if size <= 1:
                continue
            cands = [(d, i) for i, d in enumerate(x.shape)
                     if assign[i] is None and d % size == 0 and d >= size]
            if cands:
                assign[max(cands)[1]] = axis
        return tuple(assign)
    return one


def opt_abstract_and_pspecs(cfg, params_abs, spec_tree, mesh):
    """The optimizer state on ``meta`` and its ZeRO placements: AdamW's
    master and moments as the parameters with ``opt_data_axis="data"``;
    Adafactor's ``vr``/``vc`` by the largest-divisible-dimension rule."""
    from repro_torch.training import optimizer as O
    from repro_torch.uda import tree_map

    opt_abs = O.opt_init(params_abs, cfg.optimizer)
    if cfg.optimizer == "adamw":
        ps = SH.param_pspecs(spec_tree, mesh, opt_data_axis="data")
        return opt_abs, type(opt_abs)((), ps, ps, ps)
    g = _generic(mesh)
    return opt_abs, type(opt_abs)((), tree_map(g, opt_abs.vr), tree_map(g, opt_abs.vc))


def build_cell(arch: str, shape_name: str, mesh, cfg=None, batch=None) -> Cell:
    """One cell's step on ``meta`` tensors, its arguments and placements.
    ``cfg`` overrides the architecture's published config (the hill-climb's
    overrides), ``batch`` the cell's global batch (a cut to what one card
    holds)."""
    from repro_torch import serve_step as SS
    from repro_torch.models import spec as S
    from repro_torch.models import transformer as T
    from repro_torch.training import train_step as TS

    cfg = cfg or get_config(arch)
    info = SHAPES[shape_name]
    kind, B, seq = info["kind"], info["batch"] if batch is None else batch, info["seq"]
    spec_tree = T.param_specs(cfg, dtype=torch.bfloat16)
    params_abs = S.abstract_params(spec_tree)
    params_ps = SH.param_pspecs(spec_tree, mesh, opt_data_axis="data" if cfg.fsdp else None)
    daxes = SH.batch_axes(mesh)
    dsize = data_size(mesh)
    dspec = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    sharded = B % dsize == 0 and B >= dsize
    Bl = B // dsize if sharded else B

    def bspec(x):
        return (dspec if sharded else None,) + (None,) * (x.dim() - 1)

    def model_on(params, grad: bool):
        return T.Transformer(cfg, params).requires_grad_(grad)

    if kind == "train":
        batch_abs = batch_specs(cfg, shape_name, B)
        M = TS.microbatch_count(cfg, B, dsize)
        opt_abs, opt_ps = opt_abstract_and_pspecs(cfg, params_abs, spec_tree, mesh)
        ccfg = dataclasses.replace(cfg, train_microbatches=M)

        def setup():
            from repro_torch.training import optimizer as O

            model = model_on(S.abstract_params(spec_tree), True)
            return model, O.opt_init(model.params, cfg.optimizer), batch_specs(cfg, shape_name, Bl)

        metrics = {k: torch.empty((), device="meta") for k in
                   ("loss", "loss_sum", "loss_sumsq", "num_micro", "grad_norm")}
        return Cell(cfg, kind, setup, TS.make_train_step(ccfg), (params_abs, opt_abs, batch_abs),
                    (params_ps, opt_ps, {k: bspec(v) for k, v in batch_abs.items()}), (0, 1),
                    (params_abs, opt_abs, metrics),
                    (params_ps, opt_ps, {k: () for k in metrics}), B, Bl, seq, M, spec_tree)

    V = cfg.vocab_padded
    logits = torch.empty((B, V), dtype=torch.float32, device="meta")
    if kind == "prefill":
        batch_abs = batch_specs(cfg, shape_name, B)
        cache_out = T.abstract_cache(cfg, B, seq)

        def setup():
            return model_on(S.abstract_params(spec_tree), False), batch_specs(cfg, shape_name, Bl)

        return Cell(cfg, kind, setup, torch.no_grad()(SS.make_prefill(cfg, cache_len=seq)),
                    (params_abs, batch_abs),
                    (params_ps, {k: bspec(v) for k, v in batch_abs.items()}), (),
                    (logits, cache_out),
                    (bspec(logits), SH.cache_pspecs(cache_out, mesh, batch=B, seq_len=seq)),
                    B, Bl, seq, 1, spec_tree)

    cache_abs, token_abs, _ = decode_specs(cfg, shape_name, B)
    cache_ps = SH.cache_pspecs(cache_abs, mesh, batch=B, seq_len=seq)

    def setup():   # decode at the last position: the whole cache is valid
        cache, token, _ = decode_specs(cfg, shape_name, Bl)
        return model_on(S.abstract_params(spec_tree), False), cache, token, seq - 1

    # the position is a host int in the port's decode step: no device bytes
    return Cell(cfg, kind, setup, torch.no_grad()(SS.make_decode(cfg)),
                (params_abs, cache_abs, token_abs),
                (params_ps, cache_ps, bspec(token_abs)), (1,),
                (logits, cache_abs), (bspec(logits), cache_ps), B, Bl, seq, 1, spec_tree)


def materialize(cell: Cell, device, seed: int = 0) -> tuple:
    """``cell.setup()``'s arguments as real tensors on ``device`` (the
    card, or the CPU): the model's weights drawn from ``seed`` in bf16, the
    optimizer state from them, token ids 0, a zeroed cache — the tensors a
    (data=1, model=1) mesh's ``argument_bytes`` counts."""
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O

    cfg = cell.cfg
    model = T.init_model(cfg, seed=seed, dtype=torch.bfloat16, device=device)
    meta = cell.setup()

    def like(t):
        return torch.zeros(t.shape, dtype=t.dtype, device=device)

    if cell.kind == "train":
        model.requires_grad_(True)
        return model, O.opt_init(model.params, cfg.optimizer), {
            k: like(v) for k, v in meta[2].items()}
    if cell.kind == "prefill":
        return model, {k: like(v) for k, v in meta[1].items()}
    return model, T.init_cache(cfg, cell.local_batch, cell.seq, device=device), like(meta[2]), meta[3]


def collective_model(cell: Cell, mesh) -> dict:
    """Bytes a device receives in collectives during one step, by kind — a
    model from the rule table, not a measurement.  With ``dp`` the data
    axes' product, ``mp`` the ``model`` axis's size, ``M`` the microbatches
    and, for each parameter leaf, ``local`` its bytes on one device:

      * all-gather: each leaf sharded on ``data`` (FSDP) is gathered before
        each forward, ``local · dp`` bytes out, and again before a
        rematerialized backward (remat not ``"none"``): ``M · (1 or 2)``
        times a train step, once a prefill or decode step;
      * reduce-scatter (train): each such leaf's gradient, ``local`` bytes
        out in the gradients' dtype (float32 when ``M > 1``), once a step;
      * all-reduce (train, dp > 1): the gradient of each leaf not sharded on
        ``data``, its ``local`` bytes in the gradients' dtype, once a step;
      * all-reduce (mp > 1): per layer (decoder and encoder), the mixer's
        and the MLP's output activations, [local batch, seq, d_model] in
        bf16, in the forward and, for a train step, again in the backward
        (a decode step's seq is 1; an encoder layer's is encoder_seq).
    """
    cfg = cell.cfg
    dp, mp = data_size(mesh), SH.mesh_axis_size(mesh, "model")
    train = cell.kind == "train"
    params, ps = cell.args[0], cell.pspecs[0]
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    gathers = (cell.microbatches * (2 if cfg.remat != "none" else 1)) if train else 1
    for leaf, p in SH.leaf_placements(params, ps):
        local = SH.per_device_bytes(leaf, p, mesh)
        gbytes = local // leaf.element_size() * (4 if cell.microbatches > 1 else leaf.element_size())
        if any(a in SH.placement_axes(e) for e in p for a in SH.batch_axes(mesh)):
            out["all-gather"] += local * dp * gathers
            if train:
                out["reduce-scatter"] += gbytes
        elif train and dp > 1:
            out["all-reduce"] += gbytes
    if mp > 1:
        passes = 2 if train else 1
        seq = 1 if cell.kind == "decode" else cell.seq
        act = cell.local_batch * cfg.d_model * 2
        out["all-reduce"] += 2 * passes * act * (cfg.num_layers * seq
                                                 + cfg.encoder_layers * cfg.encoder_seq
                                                 * (cell.kind != "decode"))
    return {k: v for k, v in out.items() if v}


def _new_bytes(out, args) -> int:
    """Bytes of the storages in ``out`` that no argument owns."""
    from repro_torch.cost import _tensors

    owned = {t.untyped_storage()._cdata for t in _tensors(args)}
    seen, n = set(), 0
    for t in _tensors(out):
        k = t.untyped_storage()._cdata
        if k not in owned and k not in seen:
            seen.add(k)
            n += t.untyped_storage().nbytes()
    return n


def param_shards(cell: Cell, mesh) -> dict:
    """{shape: shard count} of the parameter leaves (and, for a leaf stacked
    over layers, of one layer's slice): an allocation of such a shape in the
    step — a gradient, an accumulator, an optimizer temporary — counts at
    one device's shard of it.  Where two leaves share a shape, the smaller
    count wins."""
    out: dict = {}
    for spec, ps in SH.leaf_placements(cell.spec_tree, cell.pspecs[0]):
        n = SH.shard_count(ps, mesh)
        stacked = spec.logical[:1] == ("layers",)
        for sh in [tuple(spec.shape)] + ([tuple(spec.shape[1:])] if stacked else []):
            out[sh] = min(out.get(sh, n), n)
    return {k: v for k, v in out.items() if v > 1}


def measure(cell: Cell, mesh, *, breakdown: bool = False):
    """Steps ``cell`` once on ``meta`` under a loop-scaled counter with
    memory -> (the counter, the memory dict a device, seconds)."""
    from repro_torch.cost import CostCounter

    args = cell.setup()
    t0 = time.perf_counter()
    with CostCounter(loop_scaled=True, memory=True, breakdown=breakdown,
                     shard_of=param_shards(cell, mesh)) as c:
        res = cell.step(*args)
        outputs = _new_bytes(res, (args[0].params,) + tuple(args[1:]))
    secs = time.perf_counter() - t0
    arg = sum(SH.per_device_bytes(a, p, mesh) for a, p in zip(cell.args, cell.pspecs))
    outb = sum(SH.per_device_bytes(a, p, mesh) for a, p in zip(cell.out_abs, cell.out_pspecs))
    alias = sum(SH.per_device_bytes(cell.args[i], cell.pspecs[i], mesh) for i in cell.donate)
    temp = max(c.peak_bytes - outputs, 0)
    mem = {"argument_bytes": arg, "output_bytes": outb, "temp_bytes": temp,
           "alias_bytes": alias, "peak_estimate": arg + outb + temp - alias}
    return c, mem, secs


def mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, cfg=None, mesh=None,
             verbose: bool = True) -> dict:
    """One cell's record (``status`` OK or SKIP).  ``mesh`` defaults to the
    production mesh of ``mesh_kind``, which opens the fake process group in
    this process; ``cfg`` to the published config."""
    from repro_torch import mesh as M

    cfg = cfg or get_config(arch)
    ok, reason = cell_runnable(cfg, shape_name)
    cell_id = f"{arch}.{shape_name}.{mesh_kind}"
    if not ok:
        return {"cell": cell_id, "status": "SKIP", "reason": reason}
    mesh = mesh if mesh is not None else M.make_production_mesh(multi_pod=mesh_kind == "multi")
    t0 = time.perf_counter()
    cell = build_cell(arch, shape_name, mesh, cfg=cfg)
    t_build = time.perf_counter() - t0
    c, mem, secs = measure(cell, mesh)
    mp = SH.mesh_axis_size(mesh, "model")
    result = {
        "cell": cell_id,
        "status": "OK",
        "chips": math.prod(int(s) for s in mesh.shape),
        "mesh": mesh_shape(mesh),
        "config": cfg.name,
        "global_batch": cell.batch,
        "per_device_batch": cell.local_batch,
        "seq": cell.seq,
        "microbatches": cell.microbatches,
        "flops_per_device": c.cost.flops / mp,
        "bytes_per_device": c.cost.bytes / mp,
        "collective_bytes_per_device": collective_model(cell, mesh),
        "memory": mem,
        "ops_counted": int(sum(c.ops.values())),
        "build_s": round(t_build, 3),
        "count_s": round(secs, 3),
        "notes": NOTES,
    }
    if verbose:
        print(json.dumps(result, indent=1))
    return result


def _one(arch, shape, mesh_kind, out_dir: Path, smoke: bool) -> str:
    cell = f"{arch}.{shape}.{mesh_kind}"
    cmd = [sys.executable, "-m", "repro_torch.dryrun", "--arch", arch, "--shape", shape,
           "--mesh", mesh_kind, "--out", str(out_dir)] + (["--smoke"] if smoke else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    r = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True, text=True)
    if r.returncode != 0:
        (out_dir / f"{cell}.json").write_text(json.dumps(
            {"cell": cell, "status": "FAIL", "stderr": r.stderr[-2000:]}, indent=1))
        return cell
    return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="dry run of (arch x shape x mesh) cells on meta")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="the archs' smoke configs")
    ap.add_argument("--jobs", type=int, default=1, help="cells at a time under --all")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if not args.all:
        cfg = get_config(args.arch)
        res = run_cell(args.arch, args.shape, args.mesh, cfg=cfg.smoke() if args.smoke else cfg)
        out = out_dir / f"{res['cell']}.json"
        out.write_text(json.dumps(res, indent=1))
        print(f"wrote {out}")
        return 0 if res["status"] in ("OK", "SKIP") else 1

    # --all: one subprocess per cell (each opens its own fake group)
    todo = []
    for arch in list_archs():
        for shape in SHAPES:
            cell = f"{arch}.{shape}.{args.mesh}"
            if (out_dir / f"{cell}.json").exists() and not args.force:
                print(f"skip (cached): {cell}")
                continue
            todo.append((arch, shape))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max(args.jobs, 1)) as ex:
        failures = [f for f in ex.map(lambda a: _one(*a, args.mesh, out_dir, args.smoke), todo)
                    if f]
    print(f"done: {len(todo)} cells in {time.perf_counter() - t0:.1f}s; failures: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
