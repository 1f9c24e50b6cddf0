"""The port's dry run (``repro_torch.dryrun``, ``repro_torch.hillclimb``,
``repro_torch.shapes``) on ``meta``, against the reference's shape table.

* ``shapes``: the batch and decode specs' shapes and dtypes and
  ``cell_runnable`` equal the reference's for every arch × shape (the
  port's cache is one dict a layer; the reference's stacks each group's
  layers on a leading axis);
* ``build_cell``/``run_cell`` on every smoke config and shape
  (``tests/test_torch_dryrun_cells.py``);
* on a (data=1, model=1) mesh the dry run's ``argument_bytes`` equal the
  bytes real CPU tensors of the same parameters, optimizer state and batch
  hold, exactly;
* the CLIs write their JSON under ``tmp_path``, each in a subprocess (the
  production mesh opens the fake process group).
"""
import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import get_config as rget
from repro.launch import shapes as RSH
from repro_torch import cost as C
from repro_torch import dryrun as D
from repro_torch import shapes as TSH
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs

REPO = Path(__file__).resolve().parents[1]
ARCHS = list_archs()
ONE = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
_DT = {"bfloat16": torch.bfloat16, "int32": torch.int32, "float32": torch.float32,
       "int8": torch.int8}


def _same_spec(t, r, what):
    assert tuple(t.shape) == tuple(r.shape), what
    assert t.dtype == _DT[str(r.dtype)], what
    assert t.device.type == "meta", what


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_equal_the_reference(arch):
    rcfg, tcfg = rget(arch), tget(arch)
    assert list(TSH.SHAPES) == list(RSH.SHAPES) and TSH.SHAPES == RSH.SHAPES
    for shape in TSH.SHAPES:
        assert TSH.cell_runnable(tcfg, shape) == RSH.cell_runnable(rcfg, shape)
        if TSH.SHAPES[shape]["kind"] != "decode":
            t, r = TSH.batch_specs(tcfg, shape), RSH.batch_specs(rcfg, shape)
            assert list(t) == list(r)
            for k in r:
                _same_spec(t[k], r[k], (arch, shape, k))
            continue
        if not TSH.cell_runnable(tcfg, shape)[0]:
            continue
        (tc, tt, tp), (rc, rt, rp) = TSH.decode_specs(tcfg, shape), RSH.decode_specs(rcfg, shape)
        _same_spec(tt, rt, "token")
        _same_spec(tp, rp, "pos")
        pat = len(tcfg.block_pattern)
        n_groups = tcfg.num_layers // pat
        for j in range(pat):
            for k, leaf in (rc["layers"].get(f"b{j}") or {}).items():
                assert leaf.shape[0] == n_groups
                for i in range(n_groups):
                    _same_spec(tc[i * pat + j][k],
                               jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype), (arch, j, k, i))
        for j, leaves in rc["tail"].items():
            for k, leaf in leaves.items():
                _same_spec(tc[n_groups * pat + int(j[1:])][k], leaf, (arch, j, k))
        assert len(tc) == tcfg.num_layers


def test_the_one_card_cell_against_real_tensors_on_the_cpu():
    """The chip check's counterpart: on a (1, 1) mesh the dry run's argument
    bytes are the bytes of the real parameters, optimizer state and batch
    (the flops of a real step against the meta count:
    test_torch_cost.py)."""
    from repro_torch.models import transformer as TT
    from repro_torch.training import optimizer as O

    cfg = tget("smollm_135m").smoke()
    cell = D.build_cell("smollm_135m", "train_4k", ONE, cfg=cfg)
    _, mem, _ = D.measure(cell, ONE)
    model = TT.init_model(cfg, seed=0, dtype=torch.bfloat16, device="cpu").requires_grad_(True)
    opt = O.opt_init(model.params, cfg.optimizer)
    batch = {"tokens": torch.zeros((256, 4096), dtype=torch.int32)}
    held = [t for t in model.parameters()] + [t for t in C._tensors(tuple(opt))] + [batch["tokens"]]
    assert mem["argument_bytes"] == sum(t.untyped_storage().nbytes() for t in held)
    assert cell.local_batch == 256 and mem["alias_bytes"] == mem["argument_bytes"] - sum(
        t.untyped_storage().nbytes() for t in batch.values())


def _cli(*args, timeout=300):
    r = subprocess.run([sys.executable, "-m", *args], cwd=str(REPO), capture_output=True,
                       text=True, timeout=timeout,
                       env={**__import__("os").environ, "PYTHONPATH": str(REPO / "src")})
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout


def test_dryrun_cli_one_cell_and_all_cached(tmp_path):
    out = _cli("repro_torch.dryrun", "--arch", "smollm_135m", "--shape", "decode_32k",
               "--mesh", "multi", "--smoke", "--out", str(tmp_path))
    res = json.loads((tmp_path / "smollm_135m.decode_32k.multi.json").read_text())
    assert res["status"] == "OK" and res["chips"] == 512 and "wrote" in out
    assert res["mesh"] == {"pod": 2, "data": 32, "model": 8}
    # --all: every cell but two already written (cached), those two run
    for arch in ARCHS:
        for shape in TSH.SHAPES:
            p = tmp_path / f"{arch}.{shape}.multi.json"
            if (arch, shape) not in {("whisper_base", "decode_32k"), ("xlstm_125m", "long_500k")}:
                p.write_text(json.dumps({"status": "OK"}))
            elif p.exists():
                p.unlink()
    out = _cli("repro_torch.dryrun", "--all", "--mesh", "multi", "--smoke", "--jobs", "2",
               "--out", str(tmp_path))
    assert "done: 2 cells" in out and "failures: []" in out
    for cell in ("whisper_base.decode_32k", "xlstm_125m.long_500k"):
        assert json.loads((tmp_path / f"{cell}.multi.json").read_text())["status"] == "OK"


def test_hillclimb_cli(tmp_path):
    out = _cli("repro_torch.hillclimb", "qwen3_32b", "decode_32k", "--smoke",
               "--set", "kv_cache_dtype=int8", "--label", "int8", "--out", str(tmp_path))
    rec = json.loads((tmp_path / "qwen3_32b.decode_32k.int8.json").read_text())
    assert rec["overrides"] == {"kv_cache_dtype": "int8"}
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["memory_s"] == pytest.approx(rec["bytes_per_device"] / 3.35e12)
    assert len(rec["top_bytes"]) == 12 and "top bytes contributors" in out
