"""``repro_torch.dryrun``'s ``build_cell``/``run_cell`` on every smoke
config and shape, on ``meta``, on a stand-in (32, 8) mesh (no process
group): every cell OK or SKIP, its memory the rule table's bytes and its
collective model the rule table's arithmetic.  (The smoke configs' 32-token
windows make llama4's and recurrentgemma's chunked attention a thousand
query blocks at 32k tokens, xlstm's train step 4k steps of the sLSTM: these
three take most of the file's minute.)"""
import types

import pytest

from repro_torch import dryrun as D
from repro_torch import shapes as TSH
from repro_torch import sharding as SH
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs

ARCHS = list_archs()
MESH = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(32, 8))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_smoke_cell_runs_on_meta(arch):
    cfg = tget(arch).smoke()
    for shape in TSH.SHAPES:
        res = D.run_cell(arch, shape, "single", cfg=cfg, mesh=MESH, verbose=False)
        if not TSH.cell_runnable(cfg, shape)[0]:
            assert res["status"] == "SKIP" and "quadratic" in res["reason"]
            continue
        assert res["status"] == "OK" and res["chips"] == 256
        mem = res["memory"]
        cell = D.build_cell(arch, shape, MESH, cfg=cfg)
        assert mem["argument_bytes"] == sum(
            SH.per_device_bytes(a, p, MESH) for a, p in zip(cell.args, cell.pspecs))
        assert mem["peak_estimate"] == (mem["argument_bytes"] + mem["output_bytes"]
                                        + mem["temp_bytes"] - mem["alias_bytes"])
        assert mem["temp_bytes"] > 0 and res["flops_per_device"] > 0
        assert res["per_device_batch"] == max(TSH.SHAPES[shape]["batch"] // 32, 1)
        # the activations' all-reduce over the model axis, forward (and backward)
        passes = 2 if cell.kind == "train" else 1
        seq = 1 if cell.kind == "decode" else cell.seq
        enc = cfg.encoder_layers * cfg.encoder_seq * (cell.kind != "decode")
        act = 2 * passes * cell.local_batch * cfg.d_model * 2 * (cfg.num_layers * seq + enc)
        # and, for a train step, the gradients of the leaves not sharded on
        # data (the smoke configs take one microbatch: the parameters' dtype)
        grads = sum(SH.per_device_bytes(x, p, MESH) for x, p in
                    SH.leaf_placements(cell.args[0], cell.pspecs[0])
                    if "data" not in p) if cell.kind == "train" else 0
        assert res["collective_bytes_per_device"]["all-reduce"] == act + grads
