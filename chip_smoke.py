#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PF-OLA (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --group-step   # the group step's kernel-table rows alone

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc (one
nvcc per source, all started together), holds each against its plain
PyTorch version, runs the paper's query loop through the port's public
entry points on TPC-H lineitem at 234,881,024 rows (P=8 partitions x
C=14,336 chunks x L=2048, about SF 39 — the scale one 80 GB card holds; the
paper's 48e9 rows do not fit) — Q6/Q1 queries and sessions, the Q3 join
against 58,720,256 orders (probe tables past the reference's fused budget:
K3), the supplier ⋈ nation join (K1), multi-query bundles on both kernel
paths (K1 bundle mode, K3) and the legacy scalar path (K4) — and then the
out-of-core scan: Q6, Q1-small and [Q6, Q1-small] sessions streamed from an
npy and from an encoded copy of the same rows on disk (K1, and K1's column
decode on the encoded copy), each bitwise its resident twin.  It checks
the answers against a float64 oracle and times every kernel (K5 and K6,
which no entry point reaches, included) beside its bound.  The failure,
checkpoint and straggler phases follow, then the partitions across
processes (``repro_torch.sharded``): four gloo ranks sharing the card and
one NCCL rank, spawned with ``torch.multiprocessing`` under a file store,
each reading its partitions of the npy copy — sessions, ``run_query``,
sync mode, failures and a pause resumed on two ranks, every result held
to the one-process run and every rank's launches counted.  Last, serving
(``repro_torch.service``): slot queries attaching to and leaving one
shared cyclic scan of 8 rounds, each live bank of slots stepped by K1 in
bundle mode — late joiners bitwise a solo session over the rounds they
witnessed, capacity growth to 32 slots under churn, the asyncio service
on a seeded Poisson stream against one session per query, the streamed
copies and four gloo ranks bitwise the resident run.  Then the query
construction surface: plan trees (``QuerySpec`` lowering ``PlanNode``
trees) run beside their flat GLAs through K1, K2, K3 and the decode, each
bitwise its flat twin with the same launches; the sketch GLAs (HLL,
quantile, count-min) on the per-chunk scan path held to one-pass oracles;
``monotone_envelope`` over a HAVING tree's bounds; and the online-eval
bridge (``repro_torch.metrics``) through K2 and K1.  Last, the rest of
the OLA surface: the service across processes (``OLAService(mesh=)``:
four gloo ranks, rank 0 taking the arrivals, every rank's scan equal after
every step and every outcome bitwise a one-process replay), a stream of
queries that need several rounds against one session per query, the
streamed sessions read from a parquet copy (where ``pyarrow`` imports),
and the paper's two-stage ``randomize_distributed`` over the rows in
their clustered order, with an unrandomized control whose estimate misses.
Then the dense LM family (``repro_torch.models``): greedy serving of
smollm-135m and deepseek-7b at full size and two more configs at full
width; training (``repro_torch.training``) of smollm-135m at full size —
a resumed run bitwise an uninterrupted one, the card's float32 grads held
with the CPU port's to float64 — and of deepseek-7b at full width cut to 4
layers through its 4-microbatch float32 accumulation; the
confidence-bounded gradient accumulation; and the online eval of the
trained model's loss through K2 and K1 scalar.  The MoE family runs first,
right after the build, in a process of its own while the card holds
nothing else: greedy serving of llama4-maverick (full width, 2 layers, a
prompt of 8,160 tokens whose decode crosses its 8,192-token chunk) and
grok-1 (full width, 4 layers), and training of grok-1 at full width cut to
one layer through its 16-microbatch float32 accumulation and a resume.
The dry run (``repro_torch.dryrun``) of every (arch × shape) cell on both
H100 production meshes runs on the host beside those, in a process of its
own (the fake process group must not meet a real one); at the end its
cells, one cell held against the card itself, the hill-climb's roofline
terms and the port's contract linter are read.  Every line printed while
that process ran is named in ``[dryrun-wait]``: their host times were taken
beside its load.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  The last line is the run's JSON summary.
"""
from __future__ import annotations

import json
import math
import multiprocessing
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 12
P, C, L = 8, 14_336, 2048
ROWS = P * C * L
ROUNDS = 16
DEVICE = "cuda"
try:  # the H100 SXM datasheet's figures, from the port's roofline table
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.mesh import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.mesh import PEAK_FLOPS_BF16 as BF16_FLOPS_PER_S
except ImportError:  # outside a checkout: main() fails with its message
    HBM_BYTES_PER_S = BF16_FLOPS_PER_S = None
F32_FLOPS_PER_S = 67e12  # H100 SXM float32, no tensor cores
SUM_RTOL = 1e-5  # f32 sums: the summation order differs from the plain version
ORACLE_RTOL = 1e-3  # finals against the float64 exact answer
K1 = "src/repro/kernels/fused_agg.py:363"
K2 = "src/repro/kernels/fused_agg.py:454"
K3 = "src/repro/kernels/group_agg.py:76"
K4 = "src/repro/kernels/chunk_agg.py:131"
K5 = "src/repro/kernels/chunk_agg.py:85"
K6 = "src/repro/kernels/chunk_agg.py:170"
DECODE = "src/repro/kernels/fused_agg.py:224"  # _decode_chunk, in K1's and K2's bodies
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"fused_round_step/scalar": "fused_agg.cu",
           "fused_round_step/group": "fused_agg.cu",
           "fused_round_step/bundle": "fused_agg.cu",
           "fused_prefix_states": "fused_agg.cu",
           "group_agg": "group_agg.cu",
           "shard_chunk_partials": "chunk_agg.cu",
           "chunk_agg": "chunk_agg.cu",
           "q6_agg": "chunk_agg.cu",
           "decode": "decode.cu"}
#: K5 and K6: no entry point of either package reaches them; the main path
#: must launch them no time
OFF_PATH = ("chunk_agg", "q6_agg")
#: the columns the streamed queries read, copied to the host (28 B/row)
STREAM_COLS = ("shipdate", "discount", "quantity", "extendedprice", "tax",
               "rfls", "_mask")
#: peak device memory of a streamed session above what was allocated
#: before it, in round-slices of those columns (the data is 16 of them)
STREAM_PEAK_SLICES = 4
#: the group-step kernels' times in PR 14's final run (PERF.md; NVIDIA H100
#: 80GB HBM3, 700.00 W), printed beside this run's as `pr14_ms`
PR14_MS = {"fused_round_step/group[G=4]": 165.432549,
           "fused_round_step/group[G=8192]": 24.818497,
           "fused_round_step/bundle": 172.925888,
           "group_agg[Q3]": 71.799133, "group_agg[stack]": 626.407654}
#: the times of pf_scalar (K1 scalar, K2) and pf_decode before their
#: redesign, and of the bundle that runs pf_scalar's bodies (PERF.md's kernel
#: table; NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's as
#: `pr16_ms`
PR16_MS = {"fused_round_step/scalar": 0.144752, "fused_prefix_states": 1.777168,
           "decode": 0.337696, "fused_round_step/bundle": 2.549664}
#: Q15's round-slice at SF 100 in the kernel table: olabench's tpch-sf100
#: packs 600,037,902 rows into C = 36,624 chunks of 2,048 per partition, 16
#: rounds of 2,289, grouped by 1,000,000 suppliers
Q15_CHUNKS, Q15_SUPPLIERS = 2289, 1_000_000
#: the report bundle's round-slices in olabench's two cells, (chunks a
#: partition, suppliers): tpch-sf100 as above, tpch-sf10 228 chunks of 2,048
#: rows and 100,000 suppliers
REPORT_SLICES = {"sf100": (Q15_CHUNKS, Q15_SUPPLIERS), "sf10": (228, 100_000)}
#: the K3 bundle of olabench's sf100-report-join round-slice (Q15_CHUNKS
#: chunks a partition), (A, G, share of rows with w = 1) a member: Q6, Q1 by
#: returnflag x linestatus, Q15 by 1,000,000 suppliers, Q10 by 15,000,000
#: customers, Q14 by promotion or not
JOIN_MEMBERS = ((1, 1, 0.02), (4, 4, 0.98), (1, Q15_SUPPLIERS, 0.04),
                (1, 15_000_000, 0.01), (1, 2, 0.013))
#: the [fault] and [fault-stream] phases lose partition 2 at round 5
FAIL_P, FAIL_R = 2, 5
#: the [straggler] phase's relative partition speeds: the last one at 1/4
SPEEDS = [1.0] * (P - 1) + [0.25]
#: argument that runs the [pause] phase's resume in a fresh process
RESUME_CHILD = "--resume-child"
#: argument that runs the group step's rows of the kernel table alone
#: (``group_step_rows``)
GROUP_STEP = "--group-step"
_STARTED: list = []  # background processes run() starts; main() stops any left
#: the [dist] phases: W gloo ranks sharing the card, each over P/W partitions
#: read from the npy copy; one NCCL rank over all of them
DIST_WORLD = 4
DIST_TIMEOUT = 300  # seconds a rank waits in a collective before it fails
DIST_JOIN_S = 600  # seconds a group of ranks may take in all
SYNC_C = C // 8  # the sync-mode phase's chunks per partition (a cut depth)
DIST_AT = 4  # [dist-elastic] pauses after this many rounds
#: the serving phases: the service's default rounds (one step is one
#: round-slice of C/8 = 1,792 chunks a partition); late joiners attach
#: after SERVE_JOIN steps and are held after SERVE_LATE more
SERVE_ROUNDS, SERVE_JOIN, SERVE_LATE = 8, 3, 4
#: [serve-churn]: four `supp` slots join at this step, the first at K=32
SERVE_CHURN_SUPP = 4
#: [serve-svc]: benchmarks/serve.py's workload (its QPS and eps) over 200
#: arrivals, about 8 s at 25 QPS, so that p50/p99 are percentiles
SERVE_QPS, SERVE_EPS, SERVE_N, SERVE_GRACE = 25.0, 0.05, 200, 0.05
#: [serve-svc-long]: the same queries at 16 rounds, arriving at 200 QPS, with
#: an eps at which the median query stops after SERVE_LONG_AT rounds (chosen
#: from the round-1 half-widths in the run; each later round shrinks a
#: half-width by the finite-population factor sqrt(R/k - 1))
SERVE_LONG_ROUNDS, SERVE_LONG_QPS, SERVE_LONG_AT = 16, 200.0, 4
#: [randomize-dist]: the 6-sigma limits of its statistical checks
SIGMAS = 6.0
#: [sketch]: HLL registers 2**SKETCH_LOG2M over suppkey; the histogram of
#: extendedprice over [QUANTILE_LO, QUANTILE_HI); the count-min sketch of
#: quantity (its 50 values the candidates)
SKETCH_LOG2M = 12
QUANTILE_LO, QUANTILE_HI, QUANTILE_BINS = 0.9, 105.0, 256
CMS_W, CMS_D = 1024, 4
#: the LM phases: [lm-serve] smollm-135m at full size, batch, prompt and
#: generated tokens; [lm-serve-7b] deepseek-7b at full size with its int8 KV
#: cache; [lm-widths] qwen3-32b and nemotron-4-15b at full width, the depth
#: cut to LM_WIDTH_LAYERS (batch, prompt, decode steps): 8 until PR 27, cut to 4
#: to pay for the recurrent and encoder-decoder phases
LM_SERVE, LM_7B, LM_WIDTHS, LM_WIDTH_LAYERS = (8, 128, 32), (8, 512, 16), (8, 128, 4), 4
#: incremental decode against the forward over the first LM_INCR_TOKENS of
#: two prompts: the reference test's 2e-3 with float32 weights and cache;
#: 0.25 with bf16 weights and cache — these random weights (the reference's
#: fan-in rule takes a stacked leaf's layer count as its fan-in, so the
#: projections' std is 1/sqrt(layers)) give attention scores of std about
#: 32, near one-hot softmax rows, and a bf16 rounding that differs between a
#: 16-row and a 1-row product moves a row to another key: the CPU port
#: measures 0.10 on smollm-135m at full size (0.117 with float32 weights and
#: a bf16 cache, 1e-5 with a float32 cache)
LM_INCR_TOKENS, LM_F32_INCR_TOL, LM_BF16_INCR_TOL = 16, 2e-3, 0.25
#: [lm-serve]'s card against the CPU port: float32 weights, TF32 off, two
#: prompts of LM_CPU_TOKENS and LM_CPU_STEPS decode steps, max|Δlogit| over
#: max|logit| (float32 sums in another order over 30 layers)
LM_CPU_TOKENS, LM_CPU_STEPS, LM_CPU_TOL = 32, 4, 1e-3
#: [lm-eval]: examples/online_eval.py's corpus (examples, tokens each,
#: partitions, chunk length, rounds) and its target relative width
LM_EVAL, LM_EVAL_EPS = (32_768, 32, 8, 256, 8), 0.01
#: the training phases: [lm-train] smollm-135m uncut at train_4k's sequence
#: of 4,096 (repro/launch/shapes.py; its global batch of 256 cut to 8), 6
#: steps at launch/train.py's lr; the card against the CPU port, uncut, at
#: LM_TRAIN_CPU's batch and sequence, float32, TF32 off: grads within
#: LM_CPU_TOL ([lm-serve]'s) of max|.| of the CPU port's float64 grads on
#: either device — not a 2-layer cut, whose float32 grads lie 1.5e-2 from
#: float64 on the CPU itself (the reference's fan-in rule makes a 2-layer
#: stack's weights 3.9x the uncut model's; uncut: 6.5e-4, so the check's
#: margin is about 1.5x; both from tools/lm_grad_floor.py on the CPU,
#: its float64 side float64 throughout); [lm-train-7b]
#: deepseek-7b at full width cut to 4 layers, batch 8 at 4,096, 3 steps (+1
#: traced)
LM_TRAIN, LM_TRAIN_STEPS, LM_TRAIN_LR = (8, 4096), 6, 3e-3
LM_TRAIN_CPU = (2, 128)
LM_TRAIN_7B, LM_TRAIN_7B_LAYERS, LM_TRAIN_7B_STEPS = (8, 4096), 4, 3
#: [lm-adaptive]: examples/adaptive_batch.py on smollm-135m uncut —
#: microbatches a step, examples and tokens a microbatch, the target relative
#: width, steps
LM_ADAPTIVE = (16, 4, 512, 0.08, 4)
#: the MoE phases, in a process of their own (argument MOE_CHILD) on an
#: empty card: [lm-moe-serve] (arch, layers, batch, prompt, generated
#: tokens) — llama4-maverick at full width cut 48 -> 2 layers (its first two
#: layer types, both attn_chunked; 68.8 GB of bf16 weights), a prompt of
#: 8,160 tokens whose decode crosses the 8,192-token chunk at step 32, and
#: grok-1 cut 64 -> 4 layers (42.6 GB), its softcapped attention;
#: incremental decode against the forward at the capacity factor
#: LM_MOE_NODROP, which drops nothing, in bf16 at those depths and in
#: float32 at LM_MOE_F32_LAYERS (llama4: 73 GB of float32 weights)
MOE_CHILD, MOE_CHILD_S = "--moe-child", 480
LM_MOE_ARCHS = ("llama4_maverick_400b_a17b", "grok_1_314b")
LM_MOE_SERVE = ((LM_MOE_ARCHS[0], 2, 2, 8160, 64), (LM_MOE_ARCHS[1], 4, 8, 512, 16))
LM_MOE_NODROP, LM_MOE_F32_LAYERS = 8.0, 1
#: [lm-moe-train]: grok-1 at full width cut 64 -> 1 layer, train_4k's
#: sequence of 4,096, a global batch of 16 in its config's 16 microbatches,
#: steps (+1 traced); llama4 trains only at smoke size (one full-width layer
#: with its float32 accumulation, about 36.5 + 73 GB, does not fit one
#: card); the smoke configs' card-vs-CPU check at (batch, sequence)
LM_MOE_TRAIN = (LM_MOE_ARCHS[1], 1, 16, 4096, 4)
LM_MOE_CPU = (4, 64)
#: the recurrent, encoder-decoder and vision phases, in a process of their
#: own (argument REC_CHILD) after the MoE one: [lm-rec-serve] (arch, batch,
#: prompt, generated tokens) — recurrentgemma-9b uncut with a prompt of
#: twice its 2,048-token window (the prefill keeps the last 2,048 in each
#: ring), xlstm-125m uncut; incremental decode at full width, recurrentgemma
#: cut 38 -> 3 layers (its one group: rglru, rglru, attn_chunked), xlstm
#: uncut; mlstm_chunkwise against the sequential cell at xlstm's widths
#: (batch, sequence, heads, head dim) within the reference's 1e-4
REC_CHILD, REC_CHILD_S = "--rec-child", 600
LM_REC_ARCHS = ("recurrentgemma_9b", "xlstm_125m", "whisper_base", "internvl2_1b")
LM_REC_SERVE = (("recurrentgemma_9b", 8, 4096, 32), ("xlstm_125m", 8, 512, 32))
LM_REC_INCR_LAYERS = {"recurrentgemma_9b": 3}
LM_MLSTM_CHECK, LM_MLSTM_TOL = (2, 512, 4, 384), 1e-4
#: [lm-rec-train] (arch, layers (None: uncut), batch, sequence, steps):
#: recurrentgemma at full width cut 38 -> 5 (one group and the two-rglru
#: tail) at train_4k's 4,096, the batch cut 256 -> 8; xlstm uncut with the
#: sequence cut 4,096 -> 256 (the sLSTM's host loop: a step of about 20
#: launches per token and layer, run about five times a train step under
#: the two levels of remat: 13.5 s a step at 1,024 and 4.5 s at 512, about
#: 4x the first at 4,096, past the 15 s a step and the script's time), 2
#: steps (one, a checkpoint, one) and a traced one; the four families' smoke
#: configs on the card against the CPU port at (batch, sequence)
LM_REC_TRAIN = (("recurrentgemma_9b", 5, 8, 4096, 3), ("xlstm_125m", None, 8, 256, 2))
LM_REC_CPU = (2, 64)
#: [lm-encdec] serving (arch, batch, prompt, generated): whisper-base uncut
#: over the audio stub's 1,500 frames, internvl2-1b uncut with its 256
#: patches before the prompt; then training at (batch, sequence with the
#: patches inside it, steps)
LM_ENCDEC_SERVE = (("whisper_base", 8, 64, 32), ("internvl2_1b", 8, 256, 32))
LM_ENCDEC_TRAIN = (8, 4096, 3)
#: a dtype resolves a model's weights where its forward lies within a
#: check's tolerance over this factor of the float64 forward of the same
#: weights (its floor): rounding alone stays a quarter of the way to the
#: tolerance; the incremental checks hold only there
LM_RESOLVE_FACTOR = 4.0
#: [dryrun]: ``python -m repro_torch.dryrun --all`` on the single and the
#: multi production mesh and [hillclimb]'s cell, in a process of its own
#: (argument DRYRUN_CHILD) started right after the build, at nice 19, its cells
#: DRYRUN_JOBS at a time while the MoE and recurrent processes use the card
#: (meta tensors only: it touches no card)
DRYRUN_CHILD, DRYRUN_CHILD_S, DRYRUN_JOBS = "--dryrun-child", 900, 6
HILLCLIMB = ("qwen3_32b", "train_4k", "single")
#: [dryrun-card]: one cell on a (data=1, model=1) mesh against the card
#: (arch, shape, layers, batch): deepseek-7b's train_4k cut 30 -> 2 layers
#: and 256 -> 8 sequences (its 4 microbatches of 2: the loop-scaled count
#: runs 3 of them); its flops against lm_train_flops times (6 + 2)/6 (the
#: full remat's second forward), within DRYRUN_TRAIN_RTOL
DRYRUN_CARD = ("deepseek_7b", "train_4k", 2, 8)
DRYRUN_TRAIN_RTOL = 0.02
#: a card-vs-CPU grad leaf whose CPU float32 floor passes LM_CPU_TOL over
#: this factor is held to this factor times that floor (the card's float32
#: no coarser than the CPU's) and to 1e-9 in float64
FLOOR_FACTOR = 8.0


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


_SAID: list = []  # (phase, time.monotonic()) of each line said, for [dryrun-wait]


def say(phase: str, **kv) -> None:
    _SAID.append((phase, time.monotonic()))
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("run from a checkout of the repository (src/repro_torch missing)")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if sys.argv[1:2] == [DRYRUN_CHILD]:  # the dry run's process: meta tensors, no card
        dryrun_child(Path(sys.argv[2]), jobs=int(sys.argv[3]))
        return
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    if sys.argv[1:2] == [GROUP_STEP]:  # the group step's kernel-table rows alone
        group_step_rows()
        return
    if sys.argv[1:2] == [RESUME_CHILD]:  # the [pause] phase's fresh process
        resume_child(Path(sys.argv[2]))
        return
    for flag, phases, _, _ in CHILDREN:  # an LM phases' process
        if sys.argv[1:2] == [flag]:
            child(Path(sys.argv[2]), phases)
            return
    work = ROOT / "build" / "chip_smoke_sources"  # git-ignored; deleted at the end
    try:
        run(work)
    finally:
        for proc in _STARTED:
            _stop(proc)
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(ROOT / "build" / "chip_smoke_dryrun", ignore_errors=True)


def make_data(dev):
    """TPC-H lineitem with the orders foreign key, generated, globally
    randomized and packed into [P, C, L] on the device from SEED — the
    same tensors in every process."""
    import torch

    from repro_torch import randomize
    from repro_torch.data import tpch

    cols = tpch.generate_lineitem(ROWS, num_suppliers=tpch.Q1_LARGE_SUPPLIERS,
                                  seed=SEED, device=dev)
    cols["orderkey"] = tpch.generate_orders_fk(ROWS, seed=SEED, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    parts = randomize.randomize_global(cols, gen, P)
    del cols
    return randomize.pack_partitions(parts, chunk_len=L)


def report_bundle(dev, chunks: int, suppliers: int, seed: int) -> list:
    """K1 bundle operands of one report round-slice ([P, chunks, L] rows),
    as olabench's report traffic launches it: Q6 (scalar, A = 1), Q1 by
    returnflag x linestatus (4 groups, A = 4) and Q15 by ``suppliers``
    (A = 1, w = 0 outside the quarter: about 96% of the rows), each with a
    random carry.  The same tensors from the same seed."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rand(*shape, scale):
        return torch.rand(shape, generator=g, device=dev) * scale

    def ids(groups):
        return torch.randint(0, groups, (P, chunks, L), generator=g, device=dev,
                             dtype=torch.int32)

    def counts(groups):
        return torch.randint(0, 500, (P, groups), generator=g, device=dev).float()

    w = (rand(P, chunks, L, scale=1) < 0.5).float()
    w15 = (rand(P, chunks, L, scale=1) < 0.04).float()
    v1, v4 = rand(P, chunks, L, 1, scale=1e4), rand(P, chunks, L, 4, scale=1e4)
    carry = torch.cat([rand(P, 2, scale=1e6), torch.randint(
        0, 500, (P, 1), generator=g, device=dev).float()], 1)
    members = [(v1, w, None, carry)]
    for v, w_, G in ((v4, w, 4), (v1, w15, suppliers)):
        A = v.shape[-1]
        members.append((v, w_, ids(G), rand(P, G, A, scale=1e6),
                        rand(P, G, A, scale=1e9), counts(G)))
    return members


def join_bundle(dev, chunks: int, seed: int) -> list:
    """K3 bundle operands ``(vals [P, N, A], w [P, N], gids [P, N], G)`` of
    one sf100-report-join round-slice (N = ``chunks`` · L), as
    ``scan.bundle_round_deltas`` launches it: a member a row of
    :data:`JOIN_MEMBERS`, w 0 or 1, ids uniform over its groups (Q14's
    promotion flag 1 in 6).  The same tensors from the same seed."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    N = chunks * L
    members = []
    for A, G, share in JOIN_MEMBERS:
        vals = torch.rand((P, N, A), generator=g, device=dev) * 1e4
        w = (torch.rand((P, N), generator=g, device=dev) < share).float()
        if G == 2:
            gids = (torch.randint(0, 6, (P, N), generator=g, device=dev) == 0).int()
        else:
            gids = torch.randint(0, G, (P, N), generator=g, device=dev, dtype=torch.int32)
        members.append((vals, w, gids, G))
    return members


def q6_q1s(d: float, estimator: str = "single"):
    """Q6 (low window) and Q1 with 4 groups: the streamed, fault and [dist]
    phases' queries."""
    import repro_torch as T
    from repro_torch.data import tpch

    q6 = T.make_sum_gla(tpch.q6_func, tpch.q6_cond(tpch.Q6_LOW_WINDOW), d_total=d,
                        estimator=estimator)
    q1s = T.make_groupby_gla(tpch.q1_func, tpch.q1_cond, tpch.q1_group_small,
                             num_groups=4, d_total=d, num_aggs=4, estimator=estimator)
    return q6, q1s


def q1_large(d: float):
    import repro_torch as T
    from repro_torch.data import tpch

    return T.make_groupby_gla(
        tpch.q1_func, tpch.q1_cond, tpch.q1_group_large,
        num_groups=tpch.Q1_LARGE_SUPPLIERS,
        bucket_bits=tpch.Q1_LARGE_BUCKET_BITS, d_total=d, num_aggs=4)


def digest(tree) -> str:
    """sha256 over the bytes of every tensor leaf, in tree order."""
    import hashlib

    from repro_torch.uda import tree_map

    h = hashlib.sha256()
    tree_map(lambda x: h.update(x.detach().cpu().contiguous().numpy().tobytes()), tree)
    return h.hexdigest()


def resume_child(ckpt_path: Path) -> None:
    """Resume the paused Q1-large session in this fresh process over the
    same data made again from SEED (the kernels built by the parent are
    reused from build/), drive it to the end and print its result's digest."""
    import torch

    import repro_torch as T

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    shards = make_data(dev)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess = T.Session.resume(ckpt_path, q1_large(float(ROWS)), shards, device=dev)
    t_resume = time.perf_counter() - t0
    steps = sess.steps_taken
    while not sess.done:
        sess.step()
    res = sess.result()
    torch.cuda.synchronize()
    print(json.dumps({"resumed_at": steps, "steps": sess.steps_taken,
                      "digest": digest((res.final, res.estimates)),
                      "data_s": t_data, "resume_s": t_resume,
                      "run_s": time.perf_counter() - t0 - t_resume}), flush=True)


# ---------------------------------------------------------------------------
# the [dist] phases' ranks: spawned processes sharing the card
# ---------------------------------------------------------------------------

def dist_rank(job: str, rank: int, world: int, work: str) -> None:
    """One rank of a [dist] phase, in a process of its own: joins the
    job's group (a file store under the work directory; NCCL for the
    ``nccl`` job, gloo otherwise), runs the job over its partitions and
    pickles what it got to ``dist/<job>-<rank>.pkl``, or writes its
    traceback to ``.err`` and exits non-zero.  Its peers fail with it at
    their next collective, or after DIST_TIMEOUT."""
    out = Path(work) / "dist" / f"{job}-{rank}"
    try:
        sys.path.insert(0, str(ROOT / "src"))
        import torch

        from repro_torch import sharded

        dev = torch.device(DEVICE)
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        mesh = sharded.init_partition_group(
            "nccl" if job == "nccl" and dev.type == "cuda" else "gloo",
            f"file://{Path(work) / 'dist' / job}.store", rank, world, dev,
            timeout=DIST_TIMEOUT)
        try:
            res = DIST_JOBS[job](mesh, Path(work))
            if dev.type == "cuda":  # the card's whole use now, every process's
                free, total = torch.cuda.mem_get_info()
                res["card_used_bytes"] = total - free
        finally:
            mesh.close()
        out.with_suffix(".pkl").write_bytes(pickle.dumps(res))
    except BaseException:
        out.with_suffix(".err").write_text(traceback.format_exc())
        raise SystemExit(1) from None


def _to_cpu(tree):
    import torch

    from repro_torch.uda import tree_map

    return tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, tree)


def _rank_block(mesh, work: Path, c_hi=None) -> dict:
    """This rank's partitions of the npy copy's columns, on the card."""
    import numpy as np
    import torch

    lo, hi = mesh.bounds(P)
    return {k: torch.from_numpy(np.array(  # a copy: the mmap is read-only
        np.load(work / "npy" / f"{k}.npy", mmap_mode="r")[lo:hi, :c_hi])).to(mesh.device)
        for k in STREAM_COLS}


def _rank_phase(mesh, fn, rounds: int) -> dict:
    """Run one phase on this rank: its result, seconds, host seconds in
    collectives and bytes gathered per round, launches and peak memory."""
    import torch

    from repro_torch.kernels import fused_agg as FK

    torch.cuda.synchronize()
    FK.reset_launch_counts()
    mesh.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = mesh.stats()
    return {"out": _to_cpu(out), "seconds": secs,
            "collective_s_per_round": st["seconds"] / rounds,
            "gathered_bytes_per_round": st["bytes"] / rounds, "collectives": st["calls"],
            "launches": {k: n for k, n in FK.launch_counts().items() if n},
            "peak_bytes": torch.cuda.max_memory_allocated()}


def drive(sess):
    """Step a session to its end; its result."""
    while not sess.done:
        sess.step()
    return sess.result()


def _dist_gloo(mesh, work: Path) -> dict:
    """[dist-gloo], [dist-fault] and the pauses of [dist-elastic] on this
    rank's P/W partitions of the npy copy."""
    import repro_torch as T
    from repro_torch import audit as AU
    from repro_torch import fault as FT
    from repro_torch import scan
    from repro_torch.kernels import fused_agg as FK
    from repro_torch.kernels import ref

    t0 = time.perf_counter()
    block = _rank_block(mesh, work)
    out = {"load_s": time.perf_counter() - t0, "phases": {}}
    ph = out["phases"]
    q6, q1s = q6_q1s(float(ROWS))
    q1s_sync = q6_q1s(float(ROWS), "synchronized")[1]

    def spec(gla, **kw):
        return T.QuerySpec(gla, rounds=ROUNDS, emit="kernel", **kw)

    # [dist-gloo]
    ph["run_query q6"] = _rank_phase(
        mesh, lambda: T.run_query(spec(q6), block, mesh=mesh), ROUNDS)
    for name, gla in (("q6", q6), ("q1-small", q1s), ("[q6, q1-small]", T.GLABundle([q6, q1s]))):
        ph[f"session {name}"] = _rank_phase(
            mesh, lambda gla=gla: drive(T.Session(spec(gla), block, mesh=mesh)), ROUNDS)
    npy = T.NpyMmapSource(work / "npy")
    ph["streamed q6"] = _rank_phase(
        mesh, lambda: T.Session(spec(q6), npy, mesh=mesh).run(), ROUNDS)
    # the audit of the Q6 plan across the group: every rank together
    FK.reset_launch_counts()
    mesh.reset_stats()
    t0 = time.perf_counter()
    rep = AU.audit_plan(q6, block, rounds=ROUNDS, emit="kernel", mesh=mesh,
                        checks=AU.ALL_CHECKS)
    out["audit"] = {"report": rep, "seconds": time.perf_counter() - t0,
                    "launches": FK.launch_counts(), "dispatches": FK.dispatch_counts(),
                    "collectives_after": mesh.stats()["calls"]}
    small = {k: v[:, :SYNC_C] for k, v in block.items()}
    sched = T.straggler_schedule(P, SYNC_C, ROUNDS, SPEEDS)
    for cost in (True, False):
        ph[f"sync q6 chunk, sync_cost_model={cost}"] = _rank_phase(
            mesh, lambda cost=cost: T.run_query(
                T.QuerySpec(q6, schedule=sched, sync=True, emit="chunk",
                            sync_cost_model=cost), small, mesh=mesh), ROUNDS)
    # K1 on this rank's P/W partitions of round-slice 0, from zero carries:
    # against its plain version here, against the one-process launch's rows
    # in the parent
    sl = {k: v[:, :C // ROUNDS] for k, v in block.items()}
    k1 = {}
    for name, gla in (("q6", q6), ("q1-small", q1s)):
        args = FK._member_args(gla.fused, scan.stack_init(gla, (P // mesh.world,), mesh.device), sl)
        if args[2] is None:
            got, want = FK.scalar_round_step(args[0], args[1], args[3]), \
                ref.scalar_round_step(args[0], args[1], args[3])
            got, want = (got[:, :2], got[:, 2]), (want[:, :2], want[:, 2])
        else:
            got, want = FK.group_round_step(*args), ref.group_round_step(*args)
            got, want = (got[0], got[1], got[2]), (want[0], want[1], want[2])
        k1[name] = {"kernel": _to_cpu(got), "plain": _to_cpu(want),
                    "shape": tuple(args[0].shape)}
    out["k1"] = k1
    # [dist-fault]: partition 2 lost at round 5, injected; and the npy copy
    # dying under it inside round 5 on the rank that owns it
    for family, gla in (("single", q1s), ("synchronized", q1s_sync)):
        def faulted(gla=gla, family=family):
            sess = T.Session(spec(gla, fault=T.FaultPolicy(family, fail_at={FAIL_P: FAIL_R})),
                             block, mesh=mesh)
            return drive(sess), dict(sess._fail_at)
        ph[f"fault q1-small {family}"] = _rank_phase(mesh, faulted, ROUNDS)
    lo, hi = mesh.bounds(P)
    per = C // ROUNDS
    src = FT.FailingSource(npy, {FAIL_P: FAIL_R * per + per // 2}) if lo <= FAIL_P < hi else npy

    def streamed_loss():
        sess = T.Session(spec(q6, fault=T.FaultPolicy("single")), src, mesh=mesh)
        return drive(sess), dict(sess._fail_at)
    ph["fault-stream q6"] = _rank_phase(mesh, streamed_loss, ROUNDS)
    # [dist-elastic]: Q6 and Q1-small paused after DIST_AT rounds
    for name, gla in (("q6", q6), ("q1-small", q1s)):
        def pause(gla=gla, name=name):
            sess = T.Session(spec(gla), block, mesh=mesh)
            for _ in range(DIST_AT):
                sess.step()
            t0 = time.perf_counter()
            sess.pause(work / "dist" / f"elastic-{name}.ckpt")
            return time.perf_counter() - t0
        ph[f"pause {name}"] = _rank_phase(mesh, pause, DIST_AT)
    return out


def _dist_nccl(mesh, work: Path) -> dict:
    """[dist-nccl]: one NCCL rank over every partition of the npy copy."""
    import repro_torch as T

    block = _rank_block(mesh, work)
    q6, q1s = q6_q1s(float(ROWS))
    spec = lambda g: T.QuerySpec(g, rounds=ROUNDS, emit="kernel")  # noqa: E731
    ph = {"run_query q6": _rank_phase(
        mesh, lambda: T.run_query(spec(q6), block, mesh=mesh), ROUNDS)}
    for name, gla in (("q6", q6), ("q1-small", q1s)):
        ph[f"session {name}"] = _rank_phase(
            mesh, lambda gla=gla: drive(T.Session(spec(gla), block, mesh=mesh)), ROUNDS)
    return {"phases": ph}


def _dist_resume(mesh, work: Path) -> dict:
    """[dist-elastic]: the W=4 pauses resumed on this group at
    partitions=4, each rank over its half of the npy copy's P=8 layout."""
    import repro_torch as T

    block = _rank_block(mesh, work)
    q6, q1s = q6_q1s(float(ROWS))
    ph = {}
    for name, gla in (("q6", q6), ("q1-small", q1s)):
        ph[f"resume {name}"] = _rank_phase(mesh, lambda gla=gla, name=name: drive(
            T.Session.resume(work / "dist" / f"elastic-{name}.ckpt", gla, block,
                             partitions=4, mesh=mesh)), ROUNDS - DIST_AT)
    return {"phases": ph}


# ---------------------------------------------------------------------------
# serving: the slot family and the [serve] schedule (also run by the
# [serve-dist] ranks)
# ---------------------------------------------------------------------------

def serve_family():
    """The reference service's family (``tests/test_service.py``) plus
    ``supp``: the Q1-large suppliers folded into 2^13 buckets."""
    import repro_torch as T
    from repro_torch.data import tpch

    return T.SlotFamily(
        exprs={"q6": tpch.q6_func, "qty": lambda c: c["quantity"]},
        pred_cols=("shipdate", "discount"),
        groups={"rfls": (tpch.q1_group_small, 4),
                "supp": (lambda c: T.hash_bucket(tpch.q1_group_large(c),
                                                 tpch.Q1_LARGE_BUCKET_BITS),
                         1 << tpch.Q1_LARGE_BUCKET_BITS)})


def serve_queries(having: float) -> dict:
    """[serve]'s slots: the full-pass scalar slot and the late joiners."""
    from repro_torch import SlotQuery

    return {"scalar": SlotQuery("q6", {"shipdate": (420.0, 785.0)}),
            "late": SlotQuery("qty", {"discount": (0.02, 0.08)}),
            "rfls": SlotQuery("q6", {"shipdate": (100.0, 2000.0)}, group="rfls"),
            "supp": SlotQuery("qty", {"shipdate": (0.0, 1500.0)}, group="supp"),
            "having": SlotQuery("qty", {"shipdate": (0.0, 1500.0)}, group="rfls",
                                having=having)}


def serve_schedule(scan, qs: dict, late, hook=None):
    """The [serve] schedule: the scalar slot attaches, SERVE_JOIN steps
    run, the ``late`` slots attach (``hook(scan)`` runs then), SERVE_LATE
    more steps run — each late joiner's estimate and witnessed ranges are
    kept — and the remaining steps complete the scalar slot's pass.
    Returns (records, {late name: (estimate, witnessed)}, step seconds)."""
    import torch

    recs = {"scalar": scan.attach(qs["scalar"])}
    held, secs = {}, []
    for i in range(SERVE_ROUNDS):
        if i == SERVE_JOIN:
            recs.update((n, scan.attach(qs[n])) for n in late)
            if hook is not None:
                hook(scan)
        t0 = time.perf_counter()
        scan.step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if i == SERVE_JOIN + SERVE_LATE - 1:
            held = {n: (recs[n].estimate, list(recs[n].witnessed)) for n in late}
    return recs, held, secs


def serve_launches(late) -> dict:
    """[serve]'s exact K1 bundle launches: one a step for the scalar bank
    (K <= 2), then one more a step for every other bank the late joiners
    open (K = 1 each)."""
    banks = {serve_family().bank_of(serve_queries(0.0)[n]) for n in late} - {"scalar"}
    return {"fused_round_step/bundle": SERVE_ROUNDS + (SERVE_ROUNDS - SERVE_JOIN) * len(banks)}


def _dist_serve(mesh, work: Path) -> dict:
    """[serve-dist]: the [serve] schedule (no ``supp`` slot: the npy copy
    holds no suppkey) on this rank's P/W partitions of the npy copy."""
    import repro_torch as T

    block = _rank_block(mesh, work)
    having = json.loads((work / "dist" / "serve.json").read_text())["having"]
    late = ("late", "rfls", "having")

    def run():
        scan = T.SharedScan(serve_family(), block, rounds=SERVE_ROUNDS, mesh=mesh)
        recs, held, secs = serve_schedule(scan, serve_queries(having), late)
        return {"held": held, "scalar": (recs["scalar"].estimate, recs["scalar"].scanned),
                "step_s": secs}

    return {"phases": {"serve": _rank_phase(mesh, run, SERVE_ROUNDS)}}


def serve_stream(n: int, qps: float):
    """benchmarks/serve.py's Poisson stream from SEED: ``n`` arrival times
    (seconds) at ``qps`` and their slot queries — two-year shipdate windows
    over q6 or qty, one in four grouped by rfls."""
    import numpy as np

    import repro_torch as T

    rng = np.random.default_rng(SEED)
    arr = np.cumsum(rng.exponential(1.0 / qps, size=n))
    queries = []
    for i in range(n):
        year = float(int(rng.integers(0, 6)) * 365)
        queries.append(T.SlotQuery("qty" if i % 3 == 2 else "q6",
                                   {"shipdate": (year, year + 730.0), "discount": (0.0, 1.0)},
                                   group="rfls" if i % 4 == 3 else None))
    return arr, queries


async def serve_arrivals(svc, data, arr, queries, eps: float):
    """Submit query i at ``arr[i]`` seconds (from now) under
    ``rel_width(eps)`` and await every result: (outcomes, time-to-eps and
    submit seconds a query, makespan from the first arrival, the query
    indices in submit order — over a mesh, query ``order[n]`` is op id n)."""
    import asyncio

    import repro_torch as T

    n = len(queries)
    outs, t_eps, t_sub, order = [None] * n, [0.0] * n, [0.0] * n, []

    async def one(i):
        await asyncio.sleep(float(arr[i]))
        t0 = time.perf_counter()
        h = await svc.submit(T.QuerySpec(queries[i], stop=T.rel_width(eps)), data)
        order.append(i)  # submit has no await: this is the attach order
        t_sub[i] = time.perf_counter() - t0
        outs[i] = await h.result()
        t_eps[i] = time.perf_counter() - t0

    t0 = time.perf_counter()
    await asyncio.gather(*(one(i) for i in range(n)))
    return outs, t_eps, t_sub, time.perf_counter() - t0 - float(arr[0]), order


def bank_launches(scan) -> int:
    """The K1 bundle launches the scan's next step must make: one for every
    16 slots of each live bank."""
    from repro_torch.kernels import fused_agg as FK

    return sum(-(-b.K // FK.MAX_BUNDLE_MEMBERS) for b in scan.banks.values() if b.active)


def scan_digest(scan) -> str:
    """A shared scan's observable state after a step: cursor, every bank's
    slot parameters and every attached slot's estimate, lower and upper
    bytes, ``scanned`` and rounds witnessed — equal on every rank of a
    group (each holds the merged estimates)."""
    import hashlib

    import numpy as np

    h = hashlib.sha256(str((scan.cursor, scan.steps_done)).encode())
    for name in sorted(scan.banks):
        b = scan.banks[name]
        for a in (b.expr, b.lo, b.hi, b.hv, b.generation):
            h.update(np.ascontiguousarray(a).tobytes())
        for rec in b.slots:
            if rec is None or rec.estimate is None:
                continue
            h.update(str((rec.slot, rec.scanned, len(rec.witnessed))).encode())
            for x in rec.estimate[:3]:
                h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def replay_log(scan, log, steps: int, eps: float):
    """Drive ``scan`` by a service's operation log — before step s the
    operations logged at ``steps_done == s``, in order; every attach under
    ``rel_width(eps)`` when it had a rule — for ``steps`` steps, detaching
    every slot a step completes, as the service does.  Returns ({op id:
    record}, the digest after each step, the K1 bundle launches made)."""
    import repro_torch as T

    recs, digests, want = {}, [], 0
    for s_ in range(steps + 1):
        for at, op in log:
            if at != s_:
                continue
            if op["op"] == "attach":
                expr, ranges, group, having = op["query"]
                q = T.SlotQuery(expr, {k: tuple(v) for k, v in ranges.items()}, group, having)
                recs[op["id"]] = scan.attach(q, T.rel_width(eps) if op["stop"] else None)
            else:
                scan.detach(recs[op["id"]])
        if s_ == steps:
            break
        want += bank_launches(scan)
        out = scan.step()
        check(bool(out), f"the replay of a service's log has no live slot at step {s_}")
        digests.append(scan_digest(scan))
        for rec, _ in out:
            if rec.done:
                scan.detach(rec)
    return recs, digests, want


def _dist_serve_svc(mesh, work: Path) -> dict:
    """[serve-dist-svc] and the ranks' [serve-svc-long]: each stream served
    through ``OLAService(mesh=)`` over this rank's 2 partitions of the npy
    copy — rank 0 submits, the other ranks follow — with the service's
    operation log, the scan's digest after every step, the K1 bundle
    launches each step must make and the seconds of each store record."""
    import asyncio

    import torch

    from repro_torch import service as SV
    from repro_torch import sharded as SH

    block = _rank_block(mesh, work)
    eps_long = json.loads((work / "dist" / "serve-svc.json").read_text())["eps"]
    record = {"digests": [], "want": 0, "step_s": [], "tick_s": [], "record_s": []}
    real_step, real_send = SV.SharedScan.step, SV.OLAService._post_step
    real_post, real_fetch = SH.PartitionGroup.post, SH.PartitionGroup.fetch

    def step(self):
        record["want"] += bank_launches(self)
        t0 = time.perf_counter()
        out = real_step(self)
        torch.cuda.synchronize()
        record["step_s"].append(time.perf_counter() - t0)
        record["digests"].append(scan_digest(self))
        return out

    def send(self, runner):
        """Rank 0's record and the step: its seconds."""
        t0 = time.perf_counter()
        out = real_send(self, runner)
        record["tick_s"].append(time.perf_counter() - t0)
        return out

    def timed(real):
        def io(self, *args):
            """A store record posted (rank 0) or fetched: its seconds."""
            t0 = time.perf_counter()
            out = real(self, *args)
            record["record_s"].append(time.perf_counter() - t0)
            return out
        return io

    SV.SharedScan.step, SV.OLAService._post_step = step, send
    SH.PartitionGroup.post, SH.PartitionGroup.fetch = timed(real_post), timed(real_fetch)
    phases = {}
    for name, rounds, qps, eps in (("serve-dist-svc", SERVE_ROUNDS, SERVE_QPS, SERVE_EPS),
                                   ("serve-svc-long", SERVE_LONG_ROUNDS, SERVE_LONG_QPS,
                                    eps_long)):
        record.update(digests=[], want=0, step_s=[], tick_s=[], record_s=[])
        svc = SV.OLAService(serve_family(), rounds=rounds, grace_s=SERVE_GRACE, mesh=mesh)
        arr, queries = serve_stream(SERVE_N, qps)

        def run(svc=svc, arr=arr, queries=queries, eps=eps):
            if mesh.rank:
                svc.follow(block)
                return {}

            async def main():
                async with svc:
                    got = await serve_arrivals(svc, block, arr, queries, eps)
                    return got, svc.scan_for(block).steps_done

            (outs, t_eps, _, makespan, order), steps = asyncio.run(
                asyncio.wait_for(main(), DIST_JOIN_S / 2))
            return {"outcomes": [(o.estimate, o.scanned, o.rounds_witnessed, o.converged)
                                 for o in outs],
                    "t_eps": t_eps, "makespan": makespan, "steps": steps, "order": order}

        ph = phases[name] = _rank_phase(mesh, run, 1)
        ph.update(log=svc.op_log, digests=record["digests"], want=record["want"],
                  step_s=record["step_s"], tick_s=record["tick_s"],
                  record_s=record["record_s"])
        torch.cuda.synchronize()
    return {"phases": phases}


DIST_JOBS = {"gloo": _dist_gloo, "nccl": _dist_nccl, "resume": _dist_resume,
             "serve": _dist_serve, "serve-svc": _dist_serve_svc}


def spawn_ranks(groups, work: Path) -> dict:
    """Start every rank of ``groups`` ({job: world}) at once, wait for all
    (at most DIST_JOIN_S) and return {job: [each rank's result]}; any rank
    that failed, hung or wrote nothing fails the run (the others are
    killed first)."""
    (work / "dist").mkdir(exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [(job, r, ctx.Process(target=dist_rank, args=(job, r, w, str(work)), daemon=True))
             for job, w in groups.items() for r in range(w)]
    for _, _, p in procs:
        p.start()
    deadline = time.monotonic() + DIST_JOIN_S
    for _, _, p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for _, _, p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    out, errs = {}, []
    for job, r, p in procs:
        f = work / "dist" / f"{job}-{r}"
        if f.with_suffix(".pkl").exists() and p.exitcode == 0:
            out.setdefault(job, []).append(pickle.loads(f.with_suffix(".pkl").read_bytes()))
        else:
            tail = f.with_suffix(".err").read_text()[-2500:] if f.with_suffix(".err").exists() else ""
            errs.append(f"[{job} rank {r}] exit code {p.exitcode}\n{tail}")
    check(not errs, "a [dist] rank failed:\n" + "\n".join(errs))
    return out


def _timed(ctx, name, fn, expected):
    """Run ``fn`` as one path of the main path: launch counts set to 0 just
    before it and held to ``expected`` just after (``ctx.path_launches``; a
    callable is asked after the run, for a session that stops on its own);
    its seconds into ``ctx.e2e``.  Returns (result, launches)."""
    import torch

    from repro_torch.kernels import fused_agg as FK

    torch.cuda.synchronize()
    FK.reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    ctx.e2e[name] = time.perf_counter() - t0
    return res, ctx.path_launches(name, expected() if callable(expected) else expected)


def _result_tree(res):
    """Finals, snapshots and (estimate, lower, upper) of a QueryResult or a
    list of them: what a tree must share with its flat GLA."""
    rs = res if isinstance(res, list) else [res]
    return [(r.final, r.snapshots, tuple(r.estimates[:3])) for r in rs]


def plan_phase(ctx):
    """[plan]: every plan tree of the main path lowered by QuerySpec and run
    beside its flat GLA through the same entry point on emit="kernel" —
    the same launches and the same digest of finals, snapshots and bounds.
    Returns the Having tree's result (the [envelope] phase's bounds)."""
    import torch

    import repro_torch as T
    from repro_torch.data import tpch

    dev, shards, d, g = ctx.dev, ctx.shards, ctx.d, ctx.glas
    spec = lambda x, **kw: T.QuerySpec(x, rounds=ROUNDS, emit="kernel", **kw)  # noqa: E731
    runners = {
        "run_query": lambda x: T.run_query(spec(x), shards, device=dev),
        "run_queries": lambda x: T.run_queries(spec(x), shards, device=dev),
        "session": lambda x: drive(T.Session(spec(x), shards, device=dev)),
        "encoded session": lambda x: drive(T.Session(spec(x), ctx.enc_src, device=dev)),
    }
    S = T.Scan(d)
    q1_where = T.Filter(S, tpch.q1_cond)
    trees = {
        "q6": T.SumAgg(T.Filter(S, g["q6"].fused.cond), g["q6"].fused.func),
        "q1-small": T.GroupAgg(q1_where, tpch.q1_func, num_groups=4,
                               group=tpch.q1_group_small, num_aggs=4),
        "q1-large": T.GroupAgg(q1_where, tpch.q1_func,
                               num_groups=tpch.Q1_LARGE_SUPPLIERS,
                               group=tpch.q1_group_large, num_aggs=4,
                               bucket_bits=tpch.Q1_LARGE_BUCKET_BITS),
        "nation": T.GroupAgg(T.Join(q1_where, tpch.q1_group_large, *ctx.nation, device=dev),
                             tpch.q1_func, num_groups=tpch.NUM_NATIONS, num_aggs=4),
        "q3": T.GroupAgg(T.Join(q1_where, tpch.orderkey, *ctx.orders, device=dev),
                         tpch.q6_func, num_groups=tpch.NUM_SEGMENTS),
    }
    # HAVING at one Q1-small group's exact sum: the groups are near equal,
    # so the passing set flips as the estimates move
    having_at = float(ctx.exact1s[:, 0].sort().values[1])
    trees["having"] = T.Having(trees["q1-small"], having_at)
    g = {**g, "having": T.make_having_gla(g["q1-small"], having_at)}
    four = ["q6", "q1-small", "q1-large", "nation"]
    K1G = "fused_round_step/group"
    cases = (
        ("q6", "run_query", g["q6"], trees["q6"], {"fused_prefix_states": 1}),
        ("q6", "session", g["q6"], trees["q6"], {"fused_round_step/scalar": ROUNDS}),
        ("q1-small", "run_query", g["q1-small"], trees["q1-small"], {K1G: ROUNDS}),
        ("q1-large(2^13 buckets)", "run_query", g["q1-large"], trees["q1-large"],
         {K1G: ROUNDS}),
        ("having(q1-small)", "run_query", g["having"], trees["having"], {K1G: ROUNDS}),
        ("supplier-nation join", "run_query", g["nation"], trees["nation"], {K1G: ROUNDS}),
        ("q3-orders join", "run_query", g["q3"], trees["q3"], {"group_agg": ROUNDS}),
        ("[q6, q1-small, q1-large, nation]", "run_queries", [g[k] for k in four],
         [trees[k] for k in four], {"fused_round_step/bundle": ROUNDS}),
        ("q6", "encoded session", g["q6"], trees["q6"],
         {"fused_round_step/scalar": ROUNDS, "decode": ROUNDS}),
    )
    having = None
    for name, how, flat_gla, tree, expected in cases:
        got = {}
        for kind, x in (("flat", flat_gla), ("tree", tree)):
            res, n = _timed(ctx, f"plan {how} {name} {kind}",
                            lambda x=x: runners[how](x), expected)
            got[kind] = (res, n, digest(_result_tree(res)))
        check(got["tree"][2] == got["flat"][2],
              f"[plan] {how} {name}: the tree's result differs from its flat GLA's")
        if name.startswith("having"):
            having = got["tree"][0]
        say("plan", tree=name, entry=how, vs_flat="bitwise", digest=got["tree"][2][:16],
            seconds=f"{ctx.e2e[f'plan {how} {name} tree']:.3f}",
            flat_seconds=f"{ctx.e2e[f'plan {how} {name} flat']:.3f}",
            launches=got["tree"][1])

    # a stopping rule: the Q1-large tree's session stops at the flat one's round
    stops = {}
    for kind, x in (("flat", g["q1-large"]), ("tree", trees["q1-large"])):
        sess = T.Session(spec(x, stop=T.rel_width(0.01)), shards, device=dev)
        res, _ = _timed(ctx, f"plan q1-large rel_width(0.01) {kind}", sess.run,
                        lambda sess=sess: {K1G: sess.steps_taken})
        stops[kind] = (sess.steps_taken, digest(_result_tree(res)))
    check(stops["tree"] == stops["flat"],
          f"[plan] q1-large rel_width(0.01): tree {stops['tree'][0]} rounds, flat "
          f"{stops['flat'][0]}, or the estimates differ")
    say("plan", tree="q1-large", entry="session", stop="rel_width(0.01)",
        steps_taken=stops["tree"][0], vs_flat="bitwise",
        seconds=f"{ctx.e2e['plan q1-large rel_width(0.01) tree']:.3f}",
        flat_seconds=f"{ctx.e2e['plan q1-large rel_width(0.01) flat']:.3f}")

    # two stacked Filters against one combined predicate
    lo, hi = tpch.Q6_LOW_WINDOW

    def c_lo(c):
        return (c["shipdate"] >= lo).to(torch.float32)

    def c_hi(c):
        return (c["shipdate"] < hi).to(torch.float32)

    two = T.SumAgg(T.Filter(T.Filter(S, c_lo), c_hi), tpch.q6_func)
    one = T.make_sum_gla(tpch.q6_func, lambda c: c_lo(c) * c_hi(c), d_total=d)
    finals = {}
    for kind, x in (("two filters", two), ("one predicate", one)):
        res, _ = _timed(ctx, f"plan {kind}", lambda x=x: runners["run_query"](x),
                        {"fused_prefix_states": 1})
        finals[kind] = float(res.final)
    rel = abs(finals["two filters"] - finals["one predicate"]) / abs(finals["one predicate"])
    check(rel <= 1e-6, f"[plan] two Filters off one combined predicate by {rel:.3e}")
    say("plan", tree="q6 Filter(Filter(Scan))", vs_one_predicate=f"{rel:.3e}",
        seconds=f"{ctx.e2e['plan two filters']:.3f}",
        flat_seconds=f"{ctx.e2e['plan one predicate']:.3f}")
    return having


def envelope_phase(ctx, having):
    """[envelope]: monotone_envelope over the Having tree's per-round
    bounds, on the card: lower never drops, upper never rises, lo <= hi."""
    import torch

    import repro_torch as T

    e = having.estimates
    t0 = time.perf_counter()
    lo, hi = T.monotone_envelope(e.lower, e.upper)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(lo.device == e.lower.device and lo.dtype == e.lower.dtype,
          "[envelope] not on the bounds' device, in their dtype")
    check(bool((lo[1:] >= lo[:-1]).all()), "[envelope] the lower bound drops")
    check(bool((hi[1:] <= hi[:-1]).all()), "[envelope] the upper bound rises")
    check(bool((lo <= hi).all()), "[envelope] lower above upper")
    R = lo.shape[0]

    def rows(x):  # [R, ...] -> [R, n]
        return x.reshape(R, -1)

    width = rows(e.upper - e.lower)
    keep = rows(e.info["keep"])
    say("envelope", rounds=R, device=str(lo.device), shape=tuple(lo.shape),
        raw_widened_rounds=int((width[1:] > width[:-1]).any(dim=1).sum()),
        tightened_rounds=int(((rows(lo) != rows(e.lower)) | (rows(hi) != rows(e.upper)))
                             .any(dim=1).sum()),
        having_flips=int((keep[1:] != keep[:-1]).any(dim=1).sum()),
        last_raw=[e.lower[-1].tolist(), e.upper[-1].tolist()],
        last_envelope=[lo[-1].tolist(), hi[-1].tolist()], seconds=f"{secs:.6f}")


def sketch_trees(d: float) -> dict:
    """The [sketch] phase's queries over a table of ``d`` rows."""
    import numpy as np
    import torch

    import repro_torch as T
    from repro_torch.data import tpch

    S = T.Scan(d)
    return {
        "count-distinct": T.CountDistinct(S, lambda c: c["suppkey"], log2m=SKETCH_LOG2M),
        "quantile": T.Quantile(T.Filter(S, tpch.q1_cond), lambda c: c["extendedprice"],
                               lo=QUANTILE_LO, hi=QUANTILE_HI, bins=QUANTILE_BINS, q=0.5),
        "heavy-hitters": T.HeavyHitters(S, lambda c: c["quantity"].to(torch.int32),
                                        np.arange(1, 51), width=CMS_W, depth=CMS_D),
    }


def sketch_phase(ctx):
    """[sketch]: the three sketch GLAs on the per-chunk scan path — (a) a
    session over the whole resident table for its first 2 rounds, (b)
    run_query(emit="round") over the first SYNC_C chunks a partition,
    held to oracles taken in one vectorized pass over the same rows."""
    import numpy as np
    import torch

    import repro_torch as T
    from repro_torch import sketch as SK
    from repro_torch.data import tpch
    from repro_torch.uda import tree_map

    dev, shards = ctx.dev, ctx.shards
    steps = SYNC_C // (C // ROUNDS)
    cut = {k: v[:, :SYNC_C] for k, v in shards.items()}
    d_cut = float(cut["_mask"].double().sum())
    rows = {k: cut[k].reshape(-1) for k in ("suppkey", "extendedprice", "quantity",
                                             "shipdate", "_mask")}
    live = rows["_mask"] > 0
    n_cut = int(live.sum())
    full_trees, cut_trees = sketch_trees(ctx.d), sketch_trees(d_cut)
    for name in full_trees:
        sess = T.Session(T.QuerySpec(full_trees[name], rounds=ROUNDS), shards, device=dev)

        def two_rounds():
            for _ in range(steps):
                sess.step()
            return sess.result()

        ra, got_a = _timed(ctx, f"sketch {name} session", two_rounds, {})
        rb, got_b = _timed(ctx, f"sketch {name} run_query", lambda: T.run_query(
            T.QuerySpec(cut_trees[name], rounds=steps, emit="round"), cut, device=dev), {})
        st = tree_map(lambda x: x[-1], rb.snapshots)
        check(digest(tree_map(lambda x: x[steps - 1], ra.snapshots)) == digest(st),
              f"[sketch] {name}: the session's round {steps} differs from run_query's")
        est = tuple(x[-1] for x in rb.estimates[:3])
        check(float(st.scanned) == d_cut, f"[sketch] {name}: scanned {float(st.scanned)}")
        check(all(torch.isfinite(x).all().item() for x in est),
              f"[sketch] {name}: estimates not finite")
        facts = {}
        if name == "count-distinct":
            m = 1 << SKETCH_LOG2M
            h = SK._mix32(rows["suppkey"][live])
            rest = h >> SKETCH_LOG2M
            bits = torch.zeros_like(rest)
            for k in range(32):  # bit length by comparisons, not frexp
                bits += (rest >= (1 << k)).to(rest.dtype)
            rank = (32 - SKETCH_LOG2M + 1 - bits).to(torch.float32)
            regs = torch.zeros(m, device=dev).scatter_reduce_(0, h & (m - 1), rank, "amax")
            check(torch.equal(st.registers, regs),
                  "[sketch] count-distinct: registers differ from the one-pass amax")
            distinct = torch.unique(rows["suppkey"][live]).numel()
            rel = abs(float(est[0]) - distinct) / distinct
            check(rel <= 3 * 1.04 / math.sqrt(m),
                  f"[sketch] count-distinct: estimate {float(est[0])} vs {distinct} distinct")
            facts = {"registers": "bitwise one-pass amax", "distinct": distinct,
                     "estimate": float(est[0]), "rel_err": f"{rel:.3e}",
                     "bound": f"{3 * 1.04 / math.sqrt(m):.3e}"}
        elif name == "quantile":
            w = tpch.q1_cond(rows) * rows["_mask"]
            sel = w > 0
            lo32 = torch.tensor(np.float32(QUANTILE_LO), device=dev)
            width32 = torch.tensor(
                np.float32((QUANTILE_HI - QUANTILE_LO) / QUANTILE_BINS), device=dev)
            b = torch.floor((rows["extendedprice"] - lo32) / width32)
            b = torch.clamp(b, 0, QUANTILE_BINS - 1).long()
            counts = torch.bincount(b[sel], minlength=QUANTILE_BINS).to(torch.float32)
            check(torch.equal(st.counts, counts),
                  "[sketch] quantile: counts differ from the one-pass bincount")
            vals = rows["extendedprice"][sel]
            x = float(torch.kthvalue(vals, max(1, math.ceil(0.5 * vals.numel()))).values)
            check(float(est[1]) <= x <= float(est[2]),
                  f"[sketch] quantile: DKW band [{float(est[1])}, {float(est[2])}] misses {x}")
            check(float(st.matched) == vals.numel(), "[sketch] quantile: matched")
            facts = {"counts": "bitwise one-pass bincount", "exact_median": x,
                     "estimate": float(est[0]), "band": [float(est[1]), float(est[2])]}
        else:
            q = rows["quantity"][live].to(torch.int32)
            bk = SK._cms_buckets(q, CMS_W, CMS_D)
            table = torch.stack([torch.bincount(bk[r], minlength=CMS_W)
                                 for r in range(CMS_D)]).to(torch.float32)
            check(torch.equal(st.table, table),
                  "[sketch] heavy-hitters: table differs from the one-pass count")
            exact = torch.bincount(q, minlength=51)[1:51].to(torch.float64)
            fin = rb.final.double()
            check(bool((fin >= exact).all()), "[sketch] heavy-hitters: the CMS undercounts")
            lo_, hi_ = est[1].double(), est[2].double()
            check(bool(((lo_ <= exact) & (exact <= hi_)).all()),
                  "[sketch] heavy-hitters: an exact count outside its bounds")
            facts = {"table": "bitwise one-pass count",
                     "overcount_max": float((fin - exact).max()),
                     "bound_width_max": float((hi_ - lo_).max())}
        say("sketch", query=name, session_rounds=steps, rows=ROWS,
            session_s_per_round=f"{ctx.e2e[f'sketch {name} session'] / steps:.3f}",
            run_query_rows=n_cut, run_query_s=f"{ctx.e2e[f'sketch {name} run_query']:.3f}",
            per_chunk_ms=f"{ctx.e2e[f'sketch {name} run_query'] / SYNC_C * 1e3:.4f}",
            session_vs_run_query="bitwise",
            kernel_launches=sum(got_a.values()) + sum(got_b.values()), **facts)

    # the refusals of a max monoid, with the reference's messages
    hll = full_trees["count-distinct"]
    refusals = {
        "fault": (lambda: T.Session(T.QuerySpec(hll, rounds=ROUNDS,
                                                fault=T.FaultPolicy("single")),
                                    shards, device=dev),
                  "FaultPolicy needs additive merges: excluding dead partitions is a "
                  "weighted merge, which non-additive GLAs cannot honor"),
        "kernel": (lambda: T.run_query(T.QuerySpec(hll, rounds=ROUNDS, emit="kernel"),
                                       shards, device=dev),
                   f"GLA 'hll-distinct-m{1 << SKETCH_LOG2M}' publishes neither "
                   "kernel_cols nor a fused kernel contract"),
    }
    for what, (fn, want) in refusals.items():
        try:
            fn()
            fail(f"[sketch] count-distinct under {what}: not refused")
        except ValueError as e:
            check(str(e) == want, f"[sketch] count-distinct under {what}: refused with {e}")
    say("sketch", query="count-distinct", refused=list(refusals), messages="the reference's")


def eval_phase(ctx):
    """[eval]: the online-eval bridge — make_loss_gla over one column as a
    per-row loss, A=2 (the loss and a count) through K2 and K1 scalar."""
    import torch

    import repro_torch as T
    from repro_torch import metrics as TM
    from repro_torch.data import tpch
    from repro_torch.kernels import fused_agg as FK
    from repro_torch.kernels import ref

    dev, shards = ctx.dev, ctx.shards
    loss = TM.make_loss_gla(lambda c: c["extendedprice"], d_total=ctx.d)
    truth = float(tpch.exact_answer(ctx.flat, lambda c: c["extendedprice"],
                                    lambda c: torch.ones_like(c["extendedprice"]))[0]) / ROWS
    # the A=2 shapes against the plain versions (K1 scalar on a round-slice, K2)
    vals, w, _ = FK.project(loss.fused, {k: v[:, :C // ROUNDS] for k, v in shards.items()})
    carry = torch.zeros((P, 5), device=dev)
    a, b = FK.scalar_round_step(vals, w, carry), ref.scalar_round_step(vals, w, carry)
    check(torch.equal(a[:, 4], b[:, 4]) and torch.allclose(
        a, b, rtol=SUM_RTOL, atol=SUM_RTOL * b.abs().max().item()),
        "[eval] K1 scalar at A=2 differs from its plain version")
    vals, w, _ = FK.project(loss.fused, shards)
    a, b = FK.scalar_prefix(vals, w), ref.scalar_prefix(vals, w)
    check(torch.equal(a[..., 4], b[..., 4]) and torch.allclose(
        a, b, rtol=SUM_RTOL, atol=SUM_RTOL * b.abs().max().item()),
        "[eval] K2 at A=2 differs from its plain version")
    del vals, w, a, b
    spec = lambda **kw: T.QuerySpec(loss, rounds=ROUNDS, emit="kernel", **kw)  # noqa: E731
    res, got = _timed(ctx, "eval run_query", lambda: T.run_query(spec(), shards, device=dev),
                      {"fused_prefix_states": 1})
    mean, lo, hi = TM.mean_with_bounds(res.estimates)
    check(lo[0] <= truth <= hi[0], f"[eval] round 1's bounds [{lo[0]}, {hi[0]}] miss {truth}")
    rel = abs(mean[-1] - truth) / truth
    check(rel <= ORACLE_RTOL, f"[eval] final mean {mean[-1]} vs {truth}")
    count_err = abs(float(res.final[1]) - ROWS) / ROWS
    check(count_err <= SUM_RTOL, f"[eval] the count aggregate is off the rows by {count_err:.3e}")
    say("eval", entry="run_query", truth=truth,
        round1=[float(lo[0]), float(mean[0]), float(hi[0])],
        final_mean=float(mean[-1]), rel_err=f"{rel:.3e}",
        seconds=f"{ctx.e2e['eval run_query']:.3f}", launches=got)
    sess = T.Session(spec(stop=T.rel_width(0.001)), shards, device=dev)
    res, got = _timed(ctx, "eval session", sess.run,
                      lambda: {"fused_round_step/scalar": sess.steps_taken})
    mean, lo, hi = TM.mean_with_bounds(res.estimates)
    check(sess.converged and lo[-1] <= truth <= hi[-1],
          f"[eval] the session stopped at [{lo[-1]}, {hi[-1]}], which misses {truth}")
    say("eval", entry="session", stop="rel_width(0.001)", steps_taken=sess.steps_taken,
        rounds_total=sess.rounds_total,
        mean=[float(lo[-1]), float(mean[-1]), float(hi[-1])],
        seconds=f"{ctx.e2e['eval session']:.3f}", launches=got)


#: [audit]: the checks that must pass (not skip) on each plan of the phase
AUDIT_MUST_PASS = {
    "q6 emit=chunk": ("one_chunk_pass", "o_slice_footprint", "dtype_discipline"),
    "q6 emit=kernel": ("fused_single_dispatch", "o_slice_footprint", "dtype_discipline"),
    "q1-large": ("fused_single_dispatch", "o_slice_footprint", "dtype_discipline"),
    "[q6, q1-small, q1-large, nation]": ("fused_single_dispatch", "o_slice_footprint",
                                         "dtype_discipline"),
    "q3-orders join": ("single_kernel_dispatch", "o_slice_footprint", "dtype_discipline"),
    "q6 encoded": ("bytes_moved", "fused_single_dispatch", "o_slice_footprint",
                   "dtype_discipline"),
    "q6 npy": ("o_slice_footprint", "fused_single_dispatch", "dtype_discipline"),
}


def audit_checked(tag: str, name: str, rep, must_pass=(), **line) -> None:
    """``rep`` ok, each of ``must_pass`` a pass, and the dry step's launches
    on the card its dispatches; prints the plan's line (``line`` added)."""
    check(rep.ok, f"[{tag}] {name}: the audit failed:\n{rep.summary()}")
    for c in must_pass:
        check(rep.result(c).passed, f"[{tag}] {name}: {c} did not pass: {rep.result(c)}")
    extra = {}
    for c in ("fused_single_dispatch", "single_kernel_dispatch"):
        r = rep.result(c)
        if r.passed:
            check(r.data["launches"] == r.data["dispatches"],
                  f"[{tag}] {name}: launched {r.data['launches']}, dispatched "
                  f"{r.data['dispatches']}")
            extra["dispatches"] = r.data["dispatches"]
    fp = rep.result("o_slice_footprint")
    if fp.passed:
        peak = fp.data["peak_bytes"]  # None off the card
        extra.update(handed_bytes=fp.data["handed_bytes"], slice_bytes=fp.data["slice_bytes"],
                     peak_bytes=peak, peak_in_slices=None if peak is None
                     else f"{peak / fp.data['slice_bytes']:.3f}")
    if rep.result("one_chunk_pass").passed:
        extra["chunk_steps"] = rep.result("one_chunk_pass").data["chunk_steps"]
    if rep.result("bytes_moved").passed:
        extra["bytes_ratio"] = f"{rep.result('bytes_moved').data['ratio']:.4f}"
    say(tag, plan=name, path=rep.plan["path"],
        checks={r.name: r.status for r in rep.results}, **extra, **line)


def audit_phase(ctx):
    """[audit]: the plan auditor (``repro_torch.audit``) with every check
    over the main path's full-size plans — the Q6 chunk scan, K1 scalar,
    group and bundle, K3 (Q3 past the fused budget), the encoded copy (the
    decode's own launch, the bytes moved) and the npy copy (the card's peak)
    — each report ok with its named checks passed, the dry step's launches
    its dispatches and the launch counts untouched; an audited Q1-large
    session bitwise the unaudited one; and the serving churn audit."""
    import torch

    import repro_torch as T
    from repro_torch import audit as AU
    from repro_torch.kernels import fused_agg as FK

    dev, shards, g = ctx.dev, ctx.shards, ctx.glas
    t_phase = time.perf_counter()
    bundle = T.GLABundle([g["q6"], g["q1-small"], g["q1-large"], g["nation"]])
    plans = (("q6 emit=chunk", g["q6"], "chunk", shards),
             ("q6 emit=kernel", g["q6"], "kernel", shards),
             ("q1-large", g["q1-large"], "kernel", shards),
             ("[q6, q1-small, q1-large, nation]", bundle, "kernel", shards),
             ("q3-orders join", g["q3"], "kernel", shards),
             ("q6 encoded", g["q6"], "kernel", ctx.enc_src),
             ("q6 npy", g["q6"], "kernel", ctx.npy_src))
    zero = dict.fromkeys(FK.LAUNCHES, 0)
    for name, gla, emit, data in plans:
        torch.cuda.synchronize()
        FK.reset_launch_counts()
        t0 = time.perf_counter()
        rep = AU.audit_plan(gla, data, rounds=ROUNDS, emit=emit, device=dev,
                            checks=AU.ALL_CHECKS)
        secs = time.perf_counter() - t0
        check(FK.launch_counts() == FK.dispatch_counts() == zero,
              f"[audit] {name}: the audit left launches {FK.launch_counts()}, "
              f"dispatches {FK.dispatch_counts()}")
        audit_checked("audit", name, rep, AUDIT_MUST_PASS[name], seconds=f"{secs:.3f}")
    # Session(audit=True) run to its end, held to the run's exact launches
    # (the audit's dry step among them, were it counted) and to the
    # unaudited session's bits
    spec = T.QuerySpec(g["q1-large"], rounds=ROUNDS, emit="kernel")
    k1g = {"fused_round_step/group": ROUNDS}
    held = {}

    def audited_run():
        t0 = time.perf_counter()
        held["sess"] = T.Session(spec, shards, device=dev, audit=True)
        held["audit_s"] = time.perf_counter() - t0
        return held["sess"].run()

    audited, _ = _timed(ctx, "audit session q1-large audited", audited_run, k1g)
    plain, _ = _timed(ctx, "audit session q1-large",
                      lambda: T.Session(spec, shards, device=dev).run(), k1g)
    report = held["sess"].audit_report
    check(report.ok and digest(_result_tree(audited)) == digest(_result_tree(plain)),
          "[audit] the audited Q1-large session differs from the unaudited one")
    say("audit", session="q1-large(2^13 buckets)", audit="STATIC_CHECKS",
        checks={r.name: r.status for r in report.results}, vs_unaudited="bitwise",
        audit_s=f"{held['audit_s']:.3f}",
        seconds=f"{ctx.e2e['audit session q1-large audited']:.3f}",
        unaudited_seconds=f"{ctx.e2e['audit session q1-large']:.3f}")
    # the serving churn certificate over the serving phases' family
    FK.reset_launch_counts()
    t0 = time.perf_counter()
    rep = AU.audit_service(serve_family(), shards, rounds=SERVE_ROUNDS, device=dev)
    secs = time.perf_counter() - t0
    r = rep.results[0]
    check(rep.ok and r.passed and FK.launch_counts() == FK.dispatch_counts() == zero,
          f"[audit] audit_service: {rep.summary()}; launches {FK.launch_counts()}")
    say("audit", service="serve_family()", status=r.status,
        **{k: r.data[k] for k in ("arrivals", "doublings", "banks", "stepped_capacities",
                                  "cache_miss_delta", "budget")},
        seconds=f"{secs:.3f}")
    ctx.e2e["audit phase"] = time.perf_counter() - t_phase
    say("audit", phase_s=f"{ctx.e2e['audit phase']:.3f}")


def randomize_phase(ctx):
    """[randomize-dist]: the paper's two-stage randomization on the card over
    the main table's rows in their clustered order (sorted by shipdate,
    split into P contiguous origins), beside randomize_global on the same
    rows; its output held by multiset and statistically, packed, and run
    through K2, K1 scalar and K1 group against the float64 oracle; the Q6
    session over the clustered packing is the control that misses it."""
    import numpy as np
    import torch

    import repro_torch as T
    from repro_torch import randomize
    from repro_torch.data import tpch

    dev, d = ctx.dev, ctx.d
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    # the main table's lineitem rows (make_data's draws), clustered by
    # shipdate, with each row's origin partition as an eighth 4-byte column
    cols = tpch.generate_lineitem(ROWS, num_suppliers=tpch.Q1_LARGE_SUPPLIERS, seed=SEED,
                                  device=dev)
    order = torch.argsort(cols["shipdate"], stable=True)
    cols = {k: cols.pop(k)[order] for k in list(cols)}
    del order
    n = ROWS // P
    cols["origin"] = torch.arange(P, dtype=torch.int32, device=dev).repeat_interleave(n)
    parts = [{k: v[i * n:(i + 1) * n] for k, v in cols.items()} for i in range(P)]
    # each randomizer from the same start: the clustered columns held (in
    # both peaks), nothing else
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    glob = randomize.randomize_global(cols, gen, P)
    torch.cuda.synchronize()
    t_glob = time.perf_counter() - t0
    peak_glob = torch.cuda.max_memory_allocated() - base
    del glob
    gen.manual_seed(SEED + 3)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = randomize.randomize_distributed(parts, gen)
    torch.cuda.synchronize()
    t_dist = time.perf_counter() - t0
    peak_dist = torch.cuda.max_memory_allocated() - base
    del parts

    # the multiset: every column's sorted bit patterns equal the input's
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    for k, v in cols.items():
        got = torch.sort(bits(torch.cat([o[k] for o in out]))).values
        check(torch.equal(got, torch.sort(bits(v)).values),
              f"[randomize-dist] column {k}: the output is not the input's multiset")
        del got
    # bucket sizes around N/P, and each origin's count in each target's
    # first round-slice around its expectation, within SIGMAS standard
    # deviations
    sizes = np.array([o["origin"].shape[0] for o in out])
    sigma = math.sqrt(ROWS * (1 / P) * (1 - 1 / P))
    check(sizes.sum() == ROWS and bool((np.abs(sizes - ROWS / P) <= SIGMAS * sigma).all()),
          f"[randomize-dist] bucket sizes {sizes.tolist()} (sigma {sigma:.1f})")
    c_need = max(-(-int(x) // L) for x in sizes)
    min_chunks = -(-c_need // ROUNDS) * ROUNDS
    m = min_chunks // ROUNDS * L  # rows of a target's first round-slice
    chi2, dev_max = [], 0.0
    for j, o in enumerate(out):
        counts = torch.bincount(o["origin"][:m], minlength=P).cpu().numpy()
        exp, sd = m / P, math.sqrt(m * (1 / P) * (1 - 1 / P))
        dev_max = max(dev_max, float(np.abs(counts - exp).max() / sd))
        chi2.append(float(((counts - exp) ** 2 / exp).sum()))
        check(bool((np.abs(counts - exp) <= SIGMAS * sd).all()),
              f"[randomize-dist] target {j}'s first round-slice holds {counts.tolist()}")
    for o in out:
        del o["origin"]
    packed = randomize.pack_partitions(out, chunk_len=L, min_chunks=min_chunks)
    del out
    check(tuple(packed["_mask"].shape) == (P, min_chunks, L) and min_chunks % ROUNDS == 0,
          f"[randomize-dist] packed {tuple(packed['_mask'].shape)}")
    say("randomize-dist", rows=ROWS, origins=P, columns=sorted(cols), clustered_by="shipdate",
        randomize_distributed_s=f"{t_dist:.6f}", randomize_global_s=f"{t_glob:.6f}",
        peak_device_bytes_distributed=peak_dist, peak_device_bytes_global=peak_glob,
        multiset="bitwise", bucket_sizes=sizes.tolist(), bucket_sigma=f"{sigma:.1f}",
        first_round_slice_rows=m, origin_mix_max_sigmas=f"{dev_max:.3f}",
        origin_mix_chi2_df7=[f"{x:.3f}" for x in chi2], min_chunks=min_chunks,
        packed_shape=tuple(packed["_mask"].shape), card=ctx.smi)

    # the sessions: finals through K2 and K1 group, certified estimates
    # through K1 scalar and K1 group
    q6, q1s = q6_q1s(d)
    exacts = {"q6": ctx.exact6, "q1-small": ctx.exact1s}
    spec = lambda g, **kw: T.QuerySpec(g, rounds=ROUNDS, emit="kernel", **kw)  # noqa: E731
    for qname, gla, kernel in (("q6", q6, "fused_prefix_states"),
                               ("q1-small", q1s, "fused_round_step/group")):
        res, got = _timed(ctx, f"randomize-dist run_query {qname}",
                          lambda gla=gla: T.run_query(spec(gla), packed, device=dev),
                          {kernel: 1 if kernel == "fused_prefix_states" else ROUNDS})
        ex = exacts[qname].double()
        fin = res.final.double().reshape(ex.shape)
        rel = ((fin - ex).abs() / ex.abs()).max().item()
        check(rel <= ORACLE_RTOL, f"[randomize-dist] run_query {qname}: final off by {rel:.3e}")
        say("randomize-dist", run=f"run_query {qname}", final_max_rel_err=f"{rel:.3e}",
            seconds=f"{ctx.e2e[f'randomize-dist run_query {qname}']:.3f}", launches=got)
    for qname, gla, kernel in (("q6", q6, "fused_round_step/scalar"),
                               ("q1-small", q1s, "fused_round_step/group")):
        sess = T.Session(spec(gla, stop=T.rel_width(0.01)), packed, device=dev)
        res, got = _timed(ctx, f"randomize-dist session {qname}", sess.run,
                          lambda sess=sess, kernel=kernel: {kernel: sess.steps_taken})
        e = res.estimates
        last, lo, hi = (x[-1].double() for x in (e.estimate, e.lower, e.upper))
        ex = exacts[qname].to(last.device).reshape(last.shape)
        half = (hi - lo) / 2
        check(bool(((last - ex).abs() <= 3 * half + ORACLE_RTOL * ex.abs()).all()),
              f"[randomize-dist] session {qname}: the certified estimate misses the oracle")
        say("randomize-dist", run=f"session {qname}", stop="rel_width(0.01)",
            steps_taken=sess.steps_taken,
            error_in_half_widths=[round(x, 4) for x in
                                  ((last - ex).abs() / half).reshape(-1).tolist()],
            seconds=f"{ctx.e2e[f'randomize-dist session {qname}']:.3f}", launches=got)
    del packed
    # the control: the clustered order, unrandomized (no padding: N/P rows
    # fill C chunks a partition) — its round-1 estimate misses
    clustered = {k: v.reshape(P, C, L) for k, v in cols.items() if k != "origin"}
    clustered["_mask"] = torch.ones((P, C, L), dtype=torch.float32, device=dev)
    sess = T.Session(spec(q6), clustered, device=dev)
    prog, got = _timed(ctx, "randomize-dist control", sess.step,
                       {"fused_round_step/scalar": 1})
    e = prog.estimates
    err = abs(float(e.estimate) - float(ctx.exact6))
    half = (float(e.upper) - float(e.lower)) / 2
    off = err / half if half > 0 else math.inf
    check(off > 3, f"[randomize-dist] the clustered control's round 1 lies {off:.3f} "
          "half-widths from the oracle: the coverage check could not fail")
    say("randomize-dist", run="control: q6 session over the clustered order, round 1",
        estimate=float(e.estimate), oracle=float(ctx.exact6), half_width=half,
        error_in_half_widths=f"{off:.3f}", launches=got)
    del clustered, cols, sess
    torch.cuda.empty_cache()


def parquet_phase(ctx):
    """[parquet]: the npy copy's rows saved as parquet under build/ and the
    streamed Q6, Q1-small and [Q6, Q1-small] sessions read back through
    ParquetSource, each bitwise its resident twin — or, where pyarrow does
    not import, one skip line."""
    import numpy as np
    import torch

    import repro_torch as T
    from repro_torch.data import source as DS

    try:
        import pyarrow  # noqa: F401
    except ImportError:
        print("[parquet] skipped=no pyarrow", flush=True)
        return
    npy = DS.NpyMmapSource(ctx.work / "npy")
    names = [k for k in STREAM_COLS if k != "_mask"]
    cols = {k: np.load(ctx.work / "npy" / f"{k}.npy", mmap_mode="r") for k in names}
    t0 = time.perf_counter()  # the copy is full: every partition's rows are live
    d = DS.ParquetSource.save([{k: v[p].reshape(-1) for k, v in cols.items()}
                               for p in range(P)], ctx.work / "parquet")
    t_save = time.perf_counter() - t0
    src = DS.ParquetSource(d, chunk_len=L, min_chunks=C)
    check(src.spec == npy.spec and src.fingerprint() == npy.fingerprint(),
          "[parquet] the parquet copy's spec or fingerprint differs from the npy copy's")
    say("parquet", rows=ROWS, columns=names, write_s=f"{t_save:.3f}",
        bytes=sum(f.stat().st_size for f in d.iterdir()), card=ctx.smi)
    for qname, gla, kernel in ctx.streamed:
        name = f"parquet {qname}"
        sess = T.Session(T.QuerySpec(gla, rounds=ROUNDS, emit="kernel"), src, device=ctx.dev)
        res, got = _timed(ctx, name, sess.run, {kernel: ROUNDS})
        check(ctx.same(res, ctx.twins[qname]), f"[parquet] {qname} differs from its resident twin")
        io = sess.io_stats
        say("parquet", query=qname, vs_resident="bitwise", seconds=f"{ctx.e2e[name]:.3f}",
            h2d_bytes_per_round=io["bytes"] // io["slices"], host_read_s=io["read_s"],
            h2d_copy_ms=io["copy_ms"], waited_s=io["wait_s"], launches=got)
    del src
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.synchronize()


def lm_config(arch: str, layers=None):
    """An architecture's published config, its depth cut to ``layers``."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def _events_ms(fn):
    """(fn's result, device ms between two CUDA events around it)."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def lm_decode_bytes(model, cache, batch: int) -> int:
    """Bytes one decode step must read: every weight once, but of an untied
    embedding table only the batch's rows (a tied one is the unembedding
    and is read whole), and the whole cache (the reference attends over
    every slot under a mask, and dequantizes an int8 cache in full)."""
    cfg = model.cfg
    emb = model.params["embed"]
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    if not cfg.tie_embeddings:
        weights -= (emb.shape[0] - batch) * emb.shape[1] * emb.element_size()
    return weights + _nbytes(cache)


def lm_serve(model, batch: dict, gen: int):
    """One greedy serving run with every call timed by CUDA events: the
    prefill, then ``gen - 1`` decode steps; returns (tokens [B, gen],
    prefill ms, decode ms a step, the cache).  A vision stub's patches sit
    before the prompt's positions."""
    import torch

    from repro_torch import serve_step as SS

    cfg = model.cfg
    prompt = SS.prefix_len(cfg, batch) + batch["tokens"].shape[1]
    prefill, decode = SS.make_prefill(cfg, prompt + gen + 1), SS.make_decode(cfg)
    (logits, cache), pre_ms = _events_ms(lambda: prefill(model, batch))
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out, step_ms, finite = [tok], [], torch.isfinite(logits).all()
    for i in range(gen - 1):
        (logits, cache), ms = _events_ms(lambda: decode(model, cache, tok, prompt + i))
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
        step_ms.append(ms)
        finite &= torch.isfinite(logits).all()
    check(bool(finite), f"{cfg.name}: non-finite logits")
    return torch.stack(out, dim=1), pre_ms, step_ms, cache


def lm_decode_trace(model, cache, tok, pos):
    """One decode step under torch.profiler: (kernels launched, their
    device ms, the step's wall ms on the host clock)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cost import trace_summary

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode_step(tok, cache, pos)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    s = trace_summary(prof)
    return s["kernels"], s["device_ms"], wall


def lm_incremental(model, tokens, cache_dtype, frames=None):
    """The reference's ``test_incremental_decode_matches_forward`` on the
    card: decode ``tokens`` one at a time from an empty cache, its K/V
    (bf16) cast to ``cache_dtype`` (and a recurrent layer's float32 state
    too where that is float64), and hold the last logits to the forward's.
    An encoder-decoder's cross ``xk``/``xv`` are filled from the encoder
    over ``frames``, as the reference's test fills them.  Returns
    (max|Δlogit| / max|logit|, the forward's last logits)."""
    import torch

    from repro_torch.models.layers import proj

    S = tokens.shape[1]
    batch = {"tokens": tokens} if frames is None else {"tokens": tokens, "frames": frames}
    x, _, _ = model.forward(batch)
    ref = model.unembed(x[:, -1])

    def cast(v):
        wide = v.dtype == torch.float32 and cache_dtype == torch.float64
        return v.to(cache_dtype) if v.dtype == torch.bfloat16 or wide else v

    cache = [{k: cast(v) for k, v in c.items()} for c in model.init_cache(tokens.shape[0], S)]
    if frames is not None:
        with torch.no_grad():
            enc = model._encoder_forward(frames)
            for p, c in zip(model.layers, cache):
                c["xk"] = proj(enc, p["xk"]).to(cache_dtype)
                c["xv"] = proj(enc, p["xv"]).to(cache_dtype)
    for t in range(S):
        logits, cache = model.decode_step(tokens[:, t], cache, t)
    return ((logits - ref.float()).abs().max() / ref.float().abs().max()).item(), ref


def lm_incremental_rel(model, tokens, cache_dtype) -> float:
    """:func:`lm_incremental`'s relative difference alone."""
    return lm_incremental(model, tokens, cache_dtype)[0]


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def lm_serve_phase(ctx):
    """[lm-serve]: smollm-135m at its full size with random bf16 weights
    (seeded generator on the card): greedy serving of LM_SERVE's prompts
    from token_batches, each call timed, beside greedy_generate; the
    decode's bound and its trace; incremental decode against the forward;
    and the same float32 weights on the card against the CPU port."""
    import torch

    from repro_torch import serve_step as SS
    from repro_torch.data.tokens import token_batches
    from repro_torch.models import transformer as TT
    from repro_torch.models.spec import init_params

    dev = ctx.dev
    cfg = lm_config("smollm_135m")
    B, prompt, gen = LM_SERVE
    _free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = TT.init_model(cfg, seed=SEED, dtype=torch.bfloat16, device=dev)
    batch, _ = next(token_batches(cfg, B, prompt, seed=SEED, device=dev))
    lm_serve(model, batch, 2)  # first calls: cuBLAS handles and workspaces
    toks, pre_ms, step_ms, cache = lm_serve(model, batch, gen)
    peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy = SS.greedy_generate(cfg, model, batch, steps=gen, cache_len=prompt + gen + 1)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    check(torch.equal(greedy, toks), "[lm-serve] greedy_generate's tokens differ from the timed run's")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_padded,
          "[lm-serve] a generated token lies outside the padded vocabulary")
    nbytes = lm_decode_bytes(model, cache, B)
    kernels, dev_ms, wall_ms = lm_decode_trace(model, cache, toks[:, -1], prompt + gen - 1)
    n_params = sum(p.numel() for p in model.parameters())
    dec = statistics.median(step_ms)
    say("lm-serve", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        params=n_params, weight_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
        batch=B, prompt=prompt, generated=gen, prefill_ms=f"{pre_ms:.6f}",
        prefill_tokens_per_s=f"{B * prompt / pre_ms * 1e3:.1f}",
        decode_ms_per_step=f"{dec:.6f}", decode_ms_min_max=[f"{min(step_ms):.6f}", f"{max(step_ms):.6f}"],
        decode_tokens_per_s=f"{B / dec * 1e3:.1f}", decode_bytes=nbytes,
        decode_bound_ms=f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f}",
        decode_kernels=kernels, decode_device_ms=f"{dev_ms:.6f}", decode_traced_wall_ms=f"{wall_ms:.6f}",
        decode_device_busy=f"{dev_ms / wall_ms:.3f}", greedy_generate_s=f"{greedy_s:.3f}",
        greedy_equal=True, peak_bytes=peak, card=ctx.smi)
    del cache
    # incremental decode against the forward, bf16 weights and cache (the
    # serving configuration)
    itoks = batch["tokens"][:2, :LM_INCR_TOKENS]
    rel = lm_incremental_rel(model, itoks, torch.bfloat16)
    check(rel <= LM_BF16_INCR_TOL, f"[lm-serve] bf16 incremental decode off the forward by {rel:.3e}")
    del model
    _free()
    # the same check with float32 weights and cache (the reference test's
    # 2e-3), then the device path against the CPU port on those weights
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        params = init_params(TT.param_specs(cfg, torch.float32),
                             torch.Generator(device=dev).manual_seed(SEED), dev)
        m32 = TT.Transformer(cfg, params)  # init_model's draws, in float32
        rel32 = lm_incremental_rel(m32, itoks, torch.float32)
        check(rel32 <= LM_F32_INCR_TOL, f"[lm-serve] f32 incremental decode off the forward by {rel32:.3e}")
        cpu = TT.Transformer(cfg, _tree_to(params, "cpu"))
        del params
        rels, flips = lm_against_cpu(m32, cpu, batch["tokens"][:2, :LM_CPU_TOKENS], LM_CPU_STEPS)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    check(max(rels) <= LM_CPU_TOL, f"[lm-serve] the card's logits off the CPU port's by {max(rels):.3e}")
    say("lm-serve", check="incremental decode vs forward", tokens=list(itoks.shape),
        bf16_rel=f"{rel:.3e}", bf16_tol=LM_BF16_INCR_TOL, f32_rel=f"{rel32:.3e}",
        f32_tol=LM_F32_INCR_TOL)
    say("lm-serve", check="card vs CPU port", dtype="float32", tf32=False,
        tokens=[2, LM_CPU_TOKENS], decode_steps=LM_CPU_STEPS,
        rel_per_call=[f"{r:.3e}" for r in rels], tol=LM_CPU_TOL, cache_flips=flips)
    del m32, cpu
    _free()


def lm_against_cpu(card, cpu, tokens, steps):
    """Prefill ``tokens`` and ``steps`` greedy decode steps on the card and
    on the CPU port with the same weights; each decode step starts from the
    CPU's cache copied to the card, so a cache entry that rounded the other
    way (counted: ``flips``) does not carry into the next step.  Returns
    each call's max|Δlogit| / max|logit| and the flips."""
    import torch

    from repro_torch import serve_step as SS

    S = tokens.shape[1]
    pre = SS.make_prefill(cpu.cfg, S + steps + 1)
    dec = SS.make_decode(cpu.cfg)
    a, ca = pre(cpu, {"tokens": tokens.cpu()})
    b, cb = pre(card, {"tokens": tokens})
    rels, flips = [], 0
    for t in range(steps + 1):
        rels.append(((b.cpu() - a).abs().max() / a.abs().max()).item())
        flips += sum(int((y[k].cpu() != x[k]).sum()) for x, y in zip(ca, cb) for k in x)
        if t == steps:
            break
        tok = torch.argmax(a, dim=-1).to(torch.int32)
        cb = [{k: v.to(tokens.device) for k, v in c.items()} for c in ca]
        a, ca = dec(cpu, ca, tok, S + t)
        b, cb = dec(card, cb, tok.to(tokens.device), S + t)
    return rels, flips


def lm_serve_7b_phase(ctx):
    """[lm-serve-7b]: deepseek-7b at its full size (30 layers, d=4096, MHA
    32 heads) with random bf16 weights and the int8 KV cache: greedy
    serving of LM_7B's prompts, each call timed, the decode's bound and
    trace, and the peak device memory."""
    import torch

    from repro_torch import serve_step as SS
    from repro_torch.data.tokens import token_batches
    from repro_torch.models import transformer as TT

    dev = ctx.dev
    cfg = lm_config("deepseek_7b")
    check(cfg.kv_cache_dtype == "int8", "[lm-serve-7b] deepseek-7b's config lost its int8 cache")
    B, prompt, gen = LM_7B
    _free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = TT.init_model(cfg, seed=SEED, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    batch, _ = next(token_batches(cfg, B, prompt, seed=SEED, device=dev))
    lm_serve(model, batch, 2)
    torch.cuda.reset_peak_memory_stats()
    toks, pre_ms, step_ms, cache = lm_serve(model, batch, gen)
    peak = torch.cuda.max_memory_allocated() - base
    check(all(c["k"].dtype == torch.int8 for c in cache), "[lm-serve-7b] the cache is not int8")
    greedy = SS.greedy_generate(cfg, model, batch, steps=gen, cache_len=prompt + gen + 1)
    check(torch.equal(greedy, toks), "[lm-serve-7b] greedy_generate's tokens differ from the timed run's")
    nbytes = lm_decode_bytes(model, cache, B)
    kernels, dev_ms, wall_ms = lm_decode_trace(model, cache, toks[:, -1], prompt + gen - 1)
    dec = statistics.median(step_ms)
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    say("lm-serve-7b", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        params=sum(p.numel() for p in model.parameters()), weight_bytes=wbytes,
        kv_cache="int8", cache_bytes=_nbytes(cache), batch=B, prompt=prompt, generated=gen,
        init_s=f"{init_s:.3f}", prefill_ms=f"{pre_ms:.6f}",
        prefill_tokens_per_s=f"{B * prompt / pre_ms * 1e3:.1f}",
        decode_ms_per_step=f"{dec:.6f}", decode_ms_min_max=[f"{min(step_ms):.6f}", f"{max(step_ms):.6f}"],
        decode_tokens_per_s=f"{B / dec * 1e3:.1f}", decode_bytes=nbytes,
        decode_bound_ms=f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f}",
        weights_only_bound_ms=f"{wbytes / HBM_BYTES_PER_S * 1e3:.6f}",
        decode_kernels=kernels, decode_device_ms=f"{dev_ms:.6f}", decode_traced_wall_ms=f"{wall_ms:.6f}",
        decode_device_busy=f"{dev_ms / wall_ms:.3f}", peak_bytes_serving=peak,
        peak_bytes_init=init_peak, greedy_equal=True, card=ctx.smi)
    del model, cache
    _free()


def lm_widths_phase(ctx):
    """[lm-widths]: qwen3-32b and nemotron-4-15b at their full widths, the
    depth cut to LM_WIDTH_LAYERS layers (each cut on the line): prefill and
    LM_WIDTHS' decode steps timed, and incremental decode against the
    forward in bf16 and in float32 weights and cache."""
    import torch

    from repro_torch.data.tokens import token_batches
    from repro_torch.models import transformer as TT

    dev = ctx.dev
    B, prompt, steps = LM_WIDTHS
    for arch in ("qwen3_32b", "nemotron_4_15b"):
        full = lm_config(arch)
        cfg = lm_config(arch, LM_WIDTH_LAYERS)
        _free()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = TT.init_model(cfg, seed=SEED, dtype=torch.bfloat16, device=dev)
        batch, _ = next(token_batches(cfg, B, prompt, seed=SEED, device=dev))
        lm_serve(model, batch, 2)
        toks, pre_ms, step_ms, cache = lm_serve(model, batch, steps + 1)
        peak = torch.cuda.max_memory_allocated() - base
        check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_padded,
              f"[lm-widths] {arch}: a token outside the padded vocabulary")
        nbytes = lm_decode_bytes(model, cache, B)
        del cache
        itoks = batch["tokens"][:2, :LM_INCR_TOKENS]
        rel = lm_incremental_rel(model, itoks, torch.bfloat16)
        check(rel <= LM_BF16_INCR_TOL, f"[lm-widths] {arch}: bf16 incremental decode off by {rel:.3e}")
        n_params = sum(p.numel() for p in model.parameters())
        wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
        del model
        _free()
        m32 = TT.init_model(cfg, seed=SEED, dtype=torch.float32, device=dev)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            rel32 = lm_incremental_rel(m32, itoks, torch.float32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        check(rel32 <= LM_F32_INCR_TOL, f"[lm-widths] {arch}: f32 incremental decode off by {rel32:.3e}")
        del m32
        dec = statistics.median(step_ms)
        say("lm-widths", arch=cfg.name, cut=f"num_layers {full.num_layers}->{cfg.num_layers}",
            d_model=cfg.d_model, heads=f"{cfg.num_heads}/{cfg.num_kv_heads}", head_dim=cfg.head_dim_,
            d_ff=cfg.d_ff, vocab_padded=cfg.vocab_padded, params=n_params, weight_bytes=wbytes,
            batch=B, prompt=prompt, decode_steps=steps, prefill_ms=f"{pre_ms:.6f}",
            prefill_tokens_per_s=f"{B * prompt / pre_ms * 1e3:.1f}",
            decode_ms_per_step=f"{dec:.6f}", decode_bytes=nbytes,
            decode_bound_ms=f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f}", peak_bytes=peak,
            incremental_bf16_rel=f"{rel:.3e}", incremental_f32_rel=f"{rel32:.3e}",
            tol_bf16=LM_BF16_INCR_TOL, tol_f32=LM_F32_INCR_TOL, card=ctx.smi)
    _free()


def lm_train_flops(model, batch: int, seq: int) -> float:
    """Operations of one train step: 6·N·T for the matmuls (N the
    parameters a token multiplies by, :func:`lm_active_params` — an untied
    input embedding is a lookup and not counted, nor the experts a token is
    not routed to, nor learned position tables — T = batch·seq tokens; an
    encoder's parameters multiply its batch·encoder_seq frames instead),
    plus attention's QKᵀ and PV, forward and backward: 6·batch·heads·
    head_dim times seq² for each ``attn`` layer, seq·min(window, seq) for
    each ``attn_chunked`` layer, and for an encoder-decoder encoder_seq² a
    encoder layer and seq·encoder_seq a decoder layer (cross attention).
    The recurrences' elementwise cells are not counted."""
    from repro_torch.uda import tree_leaves

    cfg = model.cfg
    n = lm_active_params(cfg, [(p.shape, p.dtype) for p in model.parameters()])
    p = model.params
    lookups = p["pos_embed"].numel() if "pos_embed" in p else 0
    n_enc = sum(t.numel() for t in tree_leaves(p["encoder"])) if "encoder" in p else 0
    enc_pos = p["encoder"]["pos"].numel() if "encoder" in p else 0
    mm = 6.0 * (n - n_enc - lookups) * batch * seq + 6.0 * (n_enc - enc_pos) * batch * cfg.encoder_seq
    window = cfg.local_window if cfg.family == "hybrid" else (cfg.attn_chunk or seq)
    sq = sum(seq * seq if lt == "attn" else seq * min(window, seq) if lt == "attn_chunked" else 0
             for lt in cfg.layer_types())
    if cfg.is_encoder_decoder:
        sq += cfg.encoder_layers * cfg.encoder_seq ** 2 + cfg.num_layers * seq * cfg.encoder_seq
    return mm + 6.0 * batch * cfg.num_heads * cfg.head_dim_ * sq


def lm_train_steps(step, model, opt, batches, n):
    """``n`` train steps, each timed on the host clock between syncs ->
    (model, opt, [(ms, loss, grad_norm)], the data cursor after them)."""
    import torch

    rows, cursor = [], None
    for _ in range(n):
        batch, cursor = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        torch.cuda.synchronize()
        rows.append(((time.perf_counter() - t0) * 1e3, m["loss"].item(), m["grad_norm"].item()))
    return model, opt, rows, cursor


def lm_train_trace(step, model, opt, batch):
    """One train step under torch.profiler -> (model, opt, (kernels
    launched, their device ms, the step's wall ms on the host clock, the
    device ms of the matmul kernels — names with "gemm" — and the five
    kernels that took the most device time, as (name, ms, launches)))."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cost import trace_summary

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, opt, _ = step(model, opt, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    s = trace_summary(prof)
    top = [(k[:72], f"{ms:.3f}", n) for k, ms, n in s["top"]]
    return model, opt, (s["kernels"], s["device_ms"], wall, s["gemm_ms"], top)


def lm_train_numbers(model, rows, batch: int, seq: int, traced, base: int, peak: int) -> dict:
    """The numbers [lm-train] and [lm-train-7b] print: step ms (median and
    spread after the first step), tokens/s, the share of the bf16 dense peak
    the step's operations reach, the traced step's busy share, memory, and
    each step's loss and grad norm."""
    import torch

    ms = [r[0] for r in rows[1:]]
    med = statistics.median(ms)
    flops = lm_train_flops(model, batch, seq)
    kernels, dev_ms, wall_ms, gemm_ms, top = traced
    return dict(
        params=sum(p.numel() for p in model.parameters()), batch=batch, seq=seq,
        microbatches=model.cfg.train_microbatches, remat=model.cfg.remat,
        step_ms_first=f"{rows[0][0]:.3f}", step_ms_median=f"{med:.3f}",
        step_ms_min_max=[f"{min(ms):.3f}", f"{max(ms):.3f}"],
        tokens_per_s=f"{batch * seq / med * 1e3:.1f}", step_flops=f"{flops:.6e}",
        bf16_peak_share=f"{flops / (med / 1e3) / BF16_FLOPS_PER_S:.4f}",
        traced_kernels=kernels, traced_device_ms=f"{dev_ms:.3f}", traced_wall_ms=f"{wall_ms:.3f}",
        device_busy=f"{dev_ms / wall_ms:.3f}", traced_gemm_ms=f"{gemm_ms:.3f}",
        traced_top_kernels=top, base_bytes=base, peak_bytes=peak,
        card_free_bytes=torch.cuda.mem_get_info()[0],
        loss=[f"{r[1]:.4f}" for r in rows], grad_norm=[f"{r[2]:.4f}" for r in rows])


def lm_train_checks(phase: str, model, shapes, rows, falls: bool = True) -> None:
    """Every loss and grad norm finite, the parameters' shapes and dtypes
    kept, and (``falls``) the last loss below the first."""
    from repro_torch.uda import tree_leaves

    check(all(math.isfinite(r[1]) and math.isfinite(r[2]) for r in rows),
          f"[{phase}] a loss or grad norm is not finite: {rows}")
    check(not falls or rows[-1][1] < rows[0][1],
          f"[{phase}] the loss did not fall: {rows[0][1]} -> {rows[-1][1]}")
    check([(t.shape, t.dtype) for t in tree_leaves(model.params)] == shapes,
          f"[{phase}] a parameter changed its shape or dtype")


def _updates_close(cpu, card, lr):
    """Parameters after one step on each device: every entry within
    LM_CPU_TOL of its leaf's max|param| but at most 0.1% of a leaf's, which
    may be off by up to 2·lr (a near-zero gradient whose sign rounds the
    other way on one side: AdamW's first step is about lr·g/|g|).  Returns
    (the entries off by more than LM_CPU_TOL, all entries, max|Δ| / lr)."""
    from repro_torch.uda import tree_leaves

    far_n, n, worst = 0, 0, 0.0
    for a, b in zip(tree_leaves(cpu), tree_leaves(card)):
        d = (b.detach().cpu() - a.detach()).abs()
        far = int((d > LM_CPU_TOL * a.abs().max().item()).sum())
        check(far <= 1e-3 * d.numel() and d.max().item() <= 2 * lr,
              f"[lm-train] the card's step moved {far} of {d.numel()} entries "
              f"off the CPU port's (max {d.max().item():.3e}, lr {lr})")
        far_n, n, worst = far_n + far, n + d.numel(), max(worst, d.max().item() / lr)
    return far_n, n, worst


def lm_train_phase(ctx):
    """[lm-train]: smollm-135m at its full size, bf16 parameters drawn from
    SEED with float32 AdamW state, the config's remat and microbatches:
    LM_TRAIN_STEPS steps on token_batches at LM_TRAIN's batch and sequence,
    timed; a second run paused after 3 steps (its train state saved and
    loaded) and resumed for 3 more, the last traced, bitwise the first; then
    the float32 grads of the same model at LM_TRAIN_CPU's tokens on the card
    and on the CPU port, each held to the CPU port's float64 grads, and one
    step's parameters on the two.  Leaves the trained model to [lm-eval]
    (``ctx.trained``)."""
    import torch

    from repro_torch import ckpt
    from repro_torch.data.tokens import token_batches
    from repro_torch.models import transformer as TT
    from repro_torch.training import train_step as TS
    from repro_torch.uda import tree_leaves, tree_map

    dev = ctx.dev
    cfg = lm_config("smollm_135m")
    B, S = LM_TRAIN
    step = TS.make_train_step(cfg, lr=LM_TRAIN_LR)
    _free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model, opt = TS.init_train_state(cfg, seed=SEED, dtype=torch.bfloat16, device=dev)
    shapes = [(t.shape, t.dtype) for t in tree_leaves(model.params)]
    model, opt, rows, _ = lm_train_steps(step, model, opt, token_batches(
        cfg, B, S, seed=SEED, device=dev), LM_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() - base
    lm_train_checks("lm-train", model, shapes, rows)
    # the same run paused after 3 steps and resumed from its checkpoint, its
    # last step traced
    m2, o2 = TS.init_train_state(cfg, seed=SEED, dtype=torch.bfloat16, device=dev)
    half = LM_TRAIN_STEPS // 2
    m2, o2, _, cursor = lm_train_steps(step, m2, o2, token_batches(cfg, B, S, seed=SEED, device=dev),
                                       half)
    path = ctx.work / "lm_train.ckpt"
    t0 = time.perf_counter()
    ckpt.save_train_state(path, m2.params, o2, half, cursor)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params, o2, at, cursor = ckpt.load_train_state(path, m2.params, o2, device=dev)
    m2 = TT.Transformer(cfg, params).requires_grad_(True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    nbytes = path.stat().st_size
    path.unlink()
    batches = token_batches(cfg, B, S, start=cursor, seed=SEED, device=dev)
    m2, o2, _, _ = lm_train_steps(step, m2, o2, batches, LM_TRAIN_STEPS - half - 1)
    m2, o2, traced = lm_train_trace(step, m2, o2, next(batches)[0])
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves({"p": model.params, "o": opt}),
                                                  tree_leaves({"p": m2.params, "o": o2})))
    ctx.trained = model.requires_grad_(False)
    check(at == half and same, f"[lm-train] {half} steps, a checkpoint and {LM_TRAIN_STEPS - half} "
          f"more differ from {LM_TRAIN_STEPS} uninterrupted steps")
    del m2, o2, params, opt
    _free()
    say("lm-train", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, cut=f"batch 256->{B}",
        lr=LM_TRAIN_LR, optimizer=cfg.optimizer, steps=LM_TRAIN_STEPS,
        **lm_train_numbers(model, rows, B, S, traced, base, peak), card=ctx.smi)
    say("lm-train", check="resume", steps=f"{half}+save+load+{LM_TRAIN_STEPS - half}",
        vs_uninterrupted="bitwise", checkpoint_bytes=nbytes, save_s=f"{save_s:.3f}",
        load_s=f"{load_s:.3f}")
    # the card against the CPU port: one float32 step, TF32 off, both held
    # to the CPU port's float64 grads
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu, ocpu = TS.init_train_state(cfg, seed=SEED, dtype=torch.float32, device="cpu")
        card = TT.Transformer(cfg, tree_map(lambda t: t.detach().to(dev, copy=True), cpu.params))
        card.requires_grad_(True)
        ocard = tree_map(lambda t: t.to(dev, copy=True), ocpu)
        batch, _ = next(token_batches(cfg, *LM_TRAIN_CPU, seed=SEED, device="cpu"))
        on_card = {k: v.to(dev) for k, v in batch.items()}
        f64 = TT.Transformer(cfg, tree_map(lambda t: t.detach().double(), cpu.params))
        (l64, _), g64 = TS.value_and_grad(f64.requires_grad_(True), cfg, batch)
        del f64
        (la, _), ga = TS.value_and_grad(cpu, cfg, batch)
        (lb, _), gb = TS.value_and_grad(card, cfg, on_card)

        def rel(xs, ys):
            return max(((x.double().cpu() - y).abs().max() / y.abs().max()).item()
                       for x, y in zip(tree_leaves(xs), tree_leaves(ys)))

        cpu_rel, card_rel, card_cpu_rel = rel(ga, g64), rel(gb, g64), rel(gb, ga)
        check(max(cpu_rel, card_rel) <= LM_CPU_TOL, f"[lm-train] float32 grads off the CPU port's "
              f"float64 ones by {cpu_rel:.3e} (CPU), {card_rel:.3e} (card)")
        del ga, gb, g64
        cstep = TS.make_train_step(cfg, lr=LM_TRAIN_LR)
        cpu, ocpu, ma = cstep(cpu, ocpu, batch)
        card, ocard, mb = cstep(card, ocard, on_card)
        flips, n, max_over_lr = _updates_close(cpu.params, card.params, LM_TRAIN_LR)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    say("lm-train", check="card vs CPU port", arch=cfg.name, layers=cfg.num_layers, dtype="float32",
        tf32=False, tokens=list(LM_TRAIN_CPU),
        loss_cpu_card_f64=[f"{la.item():.6f}", f"{lb.item():.6f}", f"{l64.item():.6f}"],
        grad_rel_vs_f64_cpu_card=[f"{cpu_rel:.3e}", f"{card_rel:.3e}"],
        grad_rel_card_vs_cpu=f"{card_cpu_rel:.3e}", params_off_after_step=f"{flips}/{n}",
        params_max_diff_over_lr=f"{max_over_lr:.3f}",
        grad_norm=[f"{ma['grad_norm'].item():.6f}", f"{mb['grad_norm'].item():.6f}"], tol=LM_CPU_TOL)
    del cpu, ocpu, card, ocard
    _free()


def lm_train_7b_phase(ctx):
    """[lm-train-7b]: deepseek-7b at its full width, the depth cut to
    LM_TRAIN_7B_LAYERS: bf16 parameters from SEED, float32 AdamW state, its
    config's 4 microbatches (the float32 accumulation path) and untied
    102,400-wide head (xent_loss in 4 chunks of 1,024): LM_TRAIN_7B_STEPS
    steps timed and one more traced."""
    import torch

    from repro_torch.data.tokens import token_batches
    from repro_torch.training import train_step as TS
    from repro_torch.uda import tree_leaves

    dev = ctx.dev
    full = lm_config("deepseek_7b")
    cfg = lm_config("deepseek_7b", LM_TRAIN_7B_LAYERS)
    check(cfg.train_microbatches == 4 and not cfg.tie_embeddings,
          "[lm-train-7b] deepseek-7b's config lost its 4 microbatches or its untied head")
    B, S = LM_TRAIN_7B
    step = TS.make_train_step(cfg, lr=LM_TRAIN_LR)
    _free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt = TS.init_train_state(cfg, seed=SEED, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = _nbytes(model.params) + _nbytes(list(opt[1:]))
    shapes = [(t.shape, t.dtype) for t in tree_leaves(model.params)]
    batches = token_batches(cfg, B, S, seed=SEED, device=dev)
    model, opt, rows, _ = lm_train_steps(step, model, opt, batches, LM_TRAIN_7B_STEPS)
    model, opt, traced = lm_train_trace(step, model, opt, next(batches)[0])
    peak = torch.cuda.max_memory_allocated() - base
    lm_train_checks("lm-train-7b", model, shapes, rows)
    say("lm-train-7b", arch=cfg.name, cut=f"num_layers {full.num_layers}->{cfg.num_layers}",
        d_model=cfg.d_model, heads=f"{cfg.num_heads}/{cfg.num_kv_heads}", d_ff=cfg.d_ff,
        vocab_padded=cfg.vocab_padded, lr=LM_TRAIN_LR, optimizer=cfg.optimizer,
        steps=f"{LM_TRAIN_7B_STEPS}+1 traced", init_s=f"{init_s:.3f}", state_bytes=state_bytes,
        **lm_train_numbers(model, rows, B, S, traced, base, peak), card=ctx.smi)
    del model, opt
    _free()


def lm_adaptive_phase(ctx):
    """[lm-adaptive]: examples/adaptive_batch.py on smollm-135m at its full
    size (bf16, AdamW): each of LM_ADAPTIVE's steps accumulates microbatch
    grads until the loss mean's relative CI width reaches the target
    (``accumulate_until_confident``), then updates; the grads held to the
    mean of the first n_used microbatch grads made again, and one step's
    seconds beside a full accumulation over every microbatch."""
    import torch

    from repro_torch.data.tokens import token_batches
    from repro_torch.training import grad_estimator as GE
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as TS
    from repro_torch.uda import tree_leaves

    dev = ctx.dev
    cfg = lm_config("smollm_135m")
    M, mb, S, target, steps = LM_ADAPTIVE
    _free()
    model, opt = TS.init_train_state(cfg, seed=SEED, dtype=torch.bfloat16, device=dev)

    def grad_fn(m, batch):
        (loss, _), g = TS.value_and_grad(m, cfg, batch)
        return loss, g

    batches = token_batches(cfg, M * mb, S, seed=SEED + 1, device=dev)
    used, widths, secs, losses = [], [], [], []
    for i in range(steps):
        toks = next(batches)[0]["tokens"].reshape(M, mb, S)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, n_used, hist = GE.accumulate_until_confident(grad_fn, model, {"tokens": toks},
                                                            target_rel_width=target)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if i == 0:  # the grads are the mean of the first n_used microbatch grads
            acc = None
            for j in range(n_used):
                g = tree_leaves(grad_fn(model, {"tokens": toks[j]})[1])
                acc = g if acc is None else [a + b for a, b in zip(acc, g)]
            check(all(torch.equal(a / n_used, b) for a, b in zip(acc, tree_leaves(grads))),
                  "[lm-adaptive] the grads differ from the mean of the first n_used microbatches'")
            del acc, g
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full, n_all, _ = GE.accumulate_until_confident(grad_fn, model, {"tokens": toks},
                                                           target_rel_width=0.0)
            torch.cuda.synchronize()
            full_s = time.perf_counter() - t0
            check(n_all == M, f"[lm-adaptive] the full accumulation used {n_all} of {M}")
            del full
        _, opt = O.opt_update(grads, opt, model.params, cfg.optimizer, lr=LM_TRAIN_LR)
        used.append(n_used)
        widths.append(hist[-1]["rel_width"])
        losses.append(hist[-1]["loss"])
        check(1 <= n_used <= M and math.isfinite(losses[-1]), f"[lm-adaptive] step {i}: {hist}")
    say("lm-adaptive", arch=cfg.name, microbatches=M, microbatch=[mb, S], target_rel_width=target,
        steps=steps, n_used=[f"{n}/{M}" for n in used], rel_width=[f"{w:.5f}" for w in widths],
        loss=[f"{x:.4f}" for x in losses], step_s=[f"{x:.3f}" for x in secs],
        full_accumulation_s=f"{full_s:.3f}", grads_vs_mean_of_first_n_used="bitwise", card=ctx.smi)
    del model, opt, grads
    _free()


def lm_eval_phase(ctx):
    """[lm-eval]: examples/online_eval.py's pipeline on the port — a corpus
    of LM_EVAL's examples (token_batches, one column a position) randomized
    and packed on the card, the mean loss of smollm-135m at full size with
    the bf16 weights [lm-train] trained (``ctx.trained``) estimated by
    run_query (K2) and by a Session under
    rel_width (K1 scalar a step), each held to the loss computed directly
    over every example; K1 scalar and K2 at the loss's shapes against their
    plain versions."""
    import numpy as np
    import torch

    import repro_torch as T
    from repro_torch import metrics as TM
    from repro_torch import randomize
    from repro_torch.data.tokens import token_batches
    from repro_torch.kernels import fused_agg as FK
    from repro_torch.kernels import ref

    dev = ctx.dev
    n, seq, parts, chunk, rounds = LM_EVAL
    model = ctx.__dict__.pop("trained")
    cfg = model.cfg
    _free()
    t0 = time.perf_counter()
    toks, _ = next(token_batches(cfg, n, seq, seed=SEED, device=dev))
    toks = toks["tokens"]
    cols = {f"t{j}": toks[:, j].contiguous() for j in range(seq)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shards = randomize.pack_partitions(randomize.randomize_global(cols, gen, parts), chunk_len=chunk)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del cols
    t0 = time.perf_counter()
    lpe = model.example_nll(toks)
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    check(bool(torch.isfinite(lpe).all()), "[lm-eval] a per-example loss is not finite")
    truth = float(lpe.double().mean())
    loss = TM.make_loss_gla(TM.lm_loss_per_example(model, seq), d_total=float(n))
    C_ = shards["_mask"].shape[1]
    # K1 scalar (a round-slice) and K2 (the whole shard) at A=2 against their
    # plain versions, on the loss's projections
    vals, w, _ = FK.project(loss.fused, {k: v[:, :C_ // rounds] for k, v in shards.items()})
    carry = torch.zeros((parts, 5), device=dev)
    a, b = FK.scalar_round_step(vals, w, carry), ref.scalar_round_step(vals, w, carry)
    errs = {"fused_round_step/scalar": (a - b).abs().max().item()}
    check(torch.equal(a[:, 4], b[:, 4]) and torch.allclose(
        a, b, rtol=SUM_RTOL, atol=SUM_RTOL * b.abs().max().item()),
        "[lm-eval] K1 scalar at the loss's shapes differs from its plain version")
    vals, w, _ = FK.project(loss.fused, shards)
    a, b = FK.scalar_prefix(vals, w), ref.scalar_prefix(vals, w)
    errs["fused_prefix_states"] = (a - b).abs().max().item()
    check(torch.equal(a[..., 4], b[..., 4]) and torch.allclose(
        a, b, rtol=SUM_RTOL, atol=SUM_RTOL * b.abs().max().item()),
        "[lm-eval] K2 at the loss's shapes differs from its plain version")
    del vals, w, a, b
    spec = lambda **kw: T.QuerySpec(loss, rounds=rounds, emit="kernel", **kw)  # noqa: E731
    res, got = _timed(ctx, "lm-eval run_query", lambda: T.run_query(spec(), shards, device=dev),
                      {"fused_prefix_states": 1})
    mean, lo, hi = TM.mean_with_bounds(res.estimates)
    rel = abs(mean[-1] - truth) / truth
    check(rel <= ORACLE_RTOL, f"[lm-eval] final mean {mean[-1]} vs the direct {truth}")
    half = (hi - lo) / 2
    off = np.abs(mean[:-1] - truth) / np.maximum(half[:-1], 1e-30)
    check(bool(np.all(off <= 3.0)), f"[lm-eval] a round's estimate lies {off.max():.2f} half-widths "
          f"off the direct mean (certified estimates hold within 3)")
    scanned = res.snapshots.scanned.cpu().numpy()
    say("lm-eval", entry="run_query", arch=cfg.name, examples=n, tokens=seq, partitions=parts,
        chunk=chunk, rounds=rounds, direct_mean=truth, final_mean=float(mean[-1]),
        rel_err=f"{rel:.3e}", round1=[float(lo[0]), float(mean[0]), float(hi[0])],
        half_widths_off=[f"{x:.3f}" for x in off],
        rounds_covering=int(np.sum((lo <= truth) & (truth <= hi))),
        scanned=[int(x) for x in scanned], seconds=f"{ctx.e2e['lm-eval run_query']:.3f}",
        direct_s=f"{direct_s:.3f}", load_s=f"{load_s:.3f}", launches=got,
        max_abs_err=errs, card=ctx.smi)
    sess = T.Session(spec(stop=T.rel_width(LM_EVAL_EPS)), shards, device=dev)
    res, got = _timed(ctx, "lm-eval session", sess.run,
                      lambda: {"fused_round_step/scalar": sess.steps_taken})
    mean, lo, hi = TM.mean_with_bounds(res.estimates)
    off_s = abs(mean[-1] - truth) / max((hi[-1] - lo[-1]) / 2, 1e-30)
    check(sess.converged and off_s <= 3.0,
          f"[lm-eval] the session stopped at [{lo[-1]}, {hi[-1]}], {off_s:.2f} half-widths off {truth}")
    say("lm-eval", entry="session", stop=f"rel_width({LM_EVAL_EPS})", steps_taken=sess.steps_taken,
        rounds_total=sess.rounds_total, examples_scanned=int(res.snapshots.scanned[-1]),
        mean=[float(lo[-1]), float(mean[-1]), float(hi[-1])], half_widths_off=f"{off_s:.3f}",
        seconds=f"{ctx.e2e['lm-eval session']:.3f}",
        run_query_seconds=f"{ctx.e2e['lm-eval run_query']:.3f}", launches=got, card=ctx.smi)
    del model, shards, loss, lpe, toks
    _free()


def _expert_std(model) -> float:
    """The std a layer's expert leaves were drawn at: 1/sqrt(fan-in), the
    fan-in being the leaf's leading dim (the layer count of a stacked leaf,
    E of a tail layer's), as the reference's rule has it."""
    layers = model.params["layers"] or model.params["tail"]
    wi = next(iter(layers.values()))["mlp"]["wi"]
    return 1.0 / math.sqrt(wi.shape[0])


def _expert_bytes(model) -> int:
    """Bytes of every expert weight (wi, wg, wo of every MoE layer)."""
    return sum(_nbytes({k: v for k, v in b["mlp"].items() if k != "router"})
               for part in ("layers", "tail") for b in model.params[part].values())


def _ring_ok(cache, cfg, pos_next: int) -> bool:
    """Each attn_chunked layer's ring holds, in slot ``p % W``, the latest
    position p below ``pos_next``, and -1 where no position was written."""
    import torch

    for c, lt in zip(cache, cfg.layer_types()):
        if lt != "attn_chunked":
            continue
        W = c["kpos"].shape[0]
        want = torch.full((W,), -1, dtype=torch.int32)
        pos = torch.arange(max(0, pos_next - W), pos_next, dtype=torch.int32)
        want[(pos % W).long()] = pos
        if not torch.equal(c["kpos"].cpu(), want):
            return False
    return True


def lm_moe_serve_phase(ctx, arch: str, layers: int, B: int, prompt: int, gen: int):
    """[lm-moe-serve]: :func:`lm_family_serve_phase` for an MoE config at
    its full width, the depth cut to ``layers`` (its ring past a chunk
    boundary where the decode crosses one, the share of pairs the prefill
    drops), then incremental decode against the forward at a capacity that
    drops nothing, in bf16 at this depth and in float32 at
    LM_MOE_F32_LAYERS."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as TT

    cfg = lm_config(arch, layers)
    # a forward over B·S tokens and a decode over B fill the experts
    # differently, so under drops they differ by design
    nodrop = dataclasses.replace(cfg, expert_capacity_factor=LM_MOE_NODROP)
    out = {}

    def bf16_incremental(model, batch):
        out["itoks"] = batch["tokens"][:2, :LM_INCR_TOKENS]
        out["rel"] = lm_incremental_rel(TT.Transformer(nodrop, model.params), out["itoks"],
                                        torch.bfloat16)
        return {}

    lm_family_serve_phase(ctx, "lm-moe-serve", arch, B, prompt, gen, layers,
                          with_model=bf16_incremental)
    rel, itoks = out["rel"], out["itoks"]
    check(rel <= LM_BF16_INCR_TOL, f"[lm-moe-serve] {arch}: bf16 incremental decode off by {rel:.3e}")
    c32 = dataclasses.replace(nodrop, num_layers=LM_MOE_F32_LAYERS)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        m32 = TT.init_model(c32, seed=SEED, dtype=torch.float32, device=ctx.dev)
        f32_bytes = sum(p.numel() * p.element_size() for p in m32.parameters())
        rel32 = lm_incremental_rel(m32, itoks, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del m32
    _free()
    check(rel32 <= LM_F32_INCR_TOL, f"[lm-moe-serve] {arch}: f32 incremental decode off by {rel32:.3e}")
    say("lm-moe-serve", arch=cfg.name, check="incremental decode vs forward",
        capacity_factor=LM_MOE_NODROP, tokens=list(itoks.shape),
        bf16=f"{cfg.num_layers} layers", bf16_rel=f"{rel:.3e}", bf16_tol=LM_BF16_INCR_TOL,
        f32=f"{c32.num_layers} layer(s), {f32_bytes} bytes of float32 weights, tf32 off",
        f32_rel=f"{rel32:.3e}", f32_tol=LM_F32_INCR_TOL)


def lm_moe_aux(model, tokens) -> float:
    """The load-balance term ``aux`` of one forward over ``tokens``."""
    import torch

    with torch.no_grad():
        return model.forward({"tokens": tokens})[1].item()


def lm_moe_train_phase(ctx):
    """[lm-moe-train]: :func:`lm_family_train_phase` for grok-1 at its full
    width, the depth cut to LM_MOE_TRAIN's layers, at train_4k's sequence:
    Adafactor, its config's 16 microbatches (the float32 accumulation) and
    remat="full", resumed bitwise; then llama4's and grok's smoke configs on
    the card against the CPU port (:func:`lm_cpu_grad_check`)."""
    arch, layers, B, S, steps = LM_MOE_TRAIN
    cfg = lm_config(arch, layers)
    check(cfg.optimizer == "adafactor" and cfg.train_microbatches == 16 and cfg.remat == "full",
          f"[lm-moe-train] {arch}'s config lost Adafactor, its 16 microbatches or remat='full'")
    lm_family_train_phase(ctx, "lm-moe-train", arch, layers, B, S, steps, resume=True)
    lm_cpu_grad_check(ctx, "lm-moe-train", LM_MOE_ARCHS, LM_MOE_CPU)


def lm_active_params(cfg, shapes) -> int:
    """Parameters a token multiplies by: all but the untied input embedding
    (a lookup) and, of each MoE layer's experts, all but the k it routes to."""
    n = sum(math.prod(s) for s, _ in shapes)
    if not cfg.tie_embeddings:
        n -= cfg.vocab_padded * cfg.d_model
    if cfg.num_experts:
        experts = cfg.num_layers * (3 if cfg.mlp_gated else 2) * cfg.d_model * cfg.d_ff
        n -= experts * (cfg.num_experts - cfg.experts_per_token)
    return n


def moe_phases(ctx) -> None:
    """The MoE phases, on a card that holds nothing else (their weights take
    43–69 GB): [lm-moe-serve] for each of LM_MOE_SERVE's configs, then
    [lm-moe-train]."""
    for row in LM_MOE_SERVE:
        lm_moe_serve_phase(ctx, *row)
    lm_moe_train_phase(ctx)


def lm_floor_rel(a, b) -> float:
    """max|a - b| / max|b| in float64."""
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


def lm_last_logits(model, tokens, frames=None):
    """The forward's last logits over ``tokens`` (and an encoder's frames),
    in the model's precision."""
    import torch

    with torch.no_grad():
        batch = {"tokens": tokens} if frames is None else {"tokens": tokens, "frames": frames}
        return model.unembed(model.forward(batch)[0][:, -1])


def lm_conditioned_specs(cfg, dtype):
    """``param_specs`` with every ``normal`` leaf of two or more dims drawn
    at std scale / sqrt(d_model) in place of the reference's scale /
    sqrt(its leading dim), which for a leaf stacked over layers is the
    layer-group count: the same draws from the same generator, each leaf
    scaled to a width's fan-in."""
    import dataclasses

    from repro_torch.models import transformer as TT
    from repro_torch.models.spec import is_spec

    def walk(t):
        if is_spec(t):
            if t.init == "normal" and len(t.shape) >= 2:
                return dataclasses.replace(t, scale=t.scale * math.sqrt(t.shape[0] / cfg.d_model))
            return t
        return {k: walk(v) for k, v in t.items()}

    return walk(TT.param_specs(cfg, dtype))


def lm_incremental_checks(ctx, phase: str, cfg, batch) -> dict:
    """Incremental decode against the forward (:func:`lm_incremental`) on
    two of ``batch``'s prompts, LM_INCR_TOKENS long, in float64, float32 and
    bf16 (TF32 off), within LM_F32_INCR_TOL, LM_F32_INCR_TOL and
    LM_BF16_INCR_TOL of max|logit|.  Each dtype's floor is its forward's
    distance from the float64 forward of the same weights (bf16's: of the
    bf16 weights; float64's: the float64 forward with the embedding scaled
    by 1 + 2^-50, a few ulps); a check holds only where its dtype resolves
    the weights, its floor within its tolerance / LM_RESOLVE_FACTOR.  The
    weights are SEED's draws (``init_params``); where float32 or bf16
    cannot resolve them (whisper's and xlstm's under the reference's fan-in
    rule, internvl's 24 layers in bf16), that dtype's check runs on the
    conditioned
    draw (:func:`lm_conditioned_specs`) instead, and where it cannot resolve
    that either, the line says "not applied" with both floors.  Float64
    must resolve SEED's draws.  A vision stub's prompts are text alone (its
    patches reach a cache only through a prefill, which keeps their K/V in
    bf16)."""
    import torch

    from repro_torch.models import transformer as TT
    from repro_torch.models.spec import init_params
    from repro_torch.uda import tree_map

    dev = ctx.dev
    t_phase = time.perf_counter()
    itoks = batch["tokens"][:2, :LM_INCR_TOKENS]
    frames = batch["frames"][:2] if cfg.is_encoder_decoder else None
    tol = {"f64": LM_F32_INCR_TOL, "f32": LM_F32_INCR_TOL, "bf16": LM_BF16_INCR_TOL}

    def runs(specs, dtypes) -> dict:
        """{dtype: (incremental rel, floor)} on ``specs(cfg, dtype)``'s
        draws from SEED."""
        def draw(dt):
            return init_params(specs(cfg, dt), torch.Generator(device=dev).manual_seed(SEED), dev)

        out = {}
        p64 = tree_map(lambda t: t.double(), draw(torch.float32))
        m64 = TT.Transformer(cfg, p64)
        if "f64" in dtypes:
            rel64, fwd64 = lm_incremental(m64, itoks, torch.float64, frames)
            p64["embed"] = p64["embed"] * (1.0 + 2.0 ** -50)
            nudged = lm_last_logits(TT.Transformer(cfg, p64), itoks, frames)
            out["f64"] = rel64, lm_floor_rel(nudged, fwd64)
        else:
            fwd64 = lm_last_logits(m64, itoks, frames)
        del p64, m64
        _free()
        if "f32" in dtypes:
            rel, fwd = lm_incremental(TT.Transformer(cfg, draw(torch.float32)), itoks,
                                      torch.float32, frames)
            out["f32"] = rel, lm_floor_rel(fwd, fwd64)
        if "bf16" in dtypes:
            # against the float64 forward of the bf16 weights: both runs the
            # check compares hold those weights, so their own rounding from
            # the float32 draws is no part of its noise
            pb = draw(torch.bfloat16)
            rel, fwd = lm_incremental(TT.Transformer(cfg, pb), itoks, torch.bfloat16, frames)
            wide = lm_last_logits(TT.Transformer(cfg, tree_map(lambda t: t.double(), pb)), itoks,
                                  frames)
            out["bf16"] = rel, lm_floor_rel(fwd, wide)
            del pb, wide
        _free()
        return out

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        seeded = runs(TT.param_specs, ("f64", "f32", "bf16"))
        coarse = [k for k in ("f32", "bf16") if seeded[k][1] > tol[k] / LM_RESOLVE_FACTOR]
        conditioned = runs(lm_conditioned_specs, coarse) if coarse else {}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    rel64, floor64 = seeded["f64"]
    check(floor64 <= tol["f64"] / LM_RESOLVE_FACTOR, f"[{phase}] {cfg.name}: float64 does not "
          f"resolve the weights (floor {floor64:.3e})")
    out = dict(arch=cfg.name, check="incremental decode vs forward", layers=cfg.num_layers,
               tokens=list(itoks.shape), text_only=cfg.frontend == "vision_stub")
    for k in ("f64", "f32", "bf16"):
        rel, floor = conditioned.get(k, seeded[k])
        draw = "conditioned" if k in conditioned else "seed"
        if floor <= tol[k] / LM_RESOLVE_FACTOR:
            check(math.isfinite(rel) and rel <= tol[k], f"[{phase}] {cfg.name}: {k} incremental "
                  f"decode off the forward by {rel:.3e} on the {draw} draw (tolerance {tol[k]})")
            out[k] = f"{rel:.3e} (tol {tol[k]}, {draw} draw, floor {floor:.3e})"
        else:
            out[k] = f"not applied (floor {floor:.3e} on the {draw} draw; rel {rel:.3e})"
        if k in conditioned:
            out[f"{k}_seed_draw"] = f"rel {seeded[k][0]:.3e}, floor {seeded[k][1]:.3e}"
    out["phase_s"] = f"{time.perf_counter() - t_phase:.1f}"
    say(phase, **out)
    return out


def lm_family_serve_phase(ctx, phase: str, arch: str, B: int, prompt: int, gen: int,
                          layers=None, with_model=None) -> dict:
    """[lm-rec-serve] / [lm-encdec] / [lm-moe-serve]: a config at its full
    width (the depth cut to ``layers`` where given), random bf16 weights
    from SEED: greedy serving of B prompts of ``prompt`` tokens (after the
    stub's patches, or over its frames) for ``gen`` tokens, each call timed,
    beside greedy_generate; a ring's kpos after the prefill and at the end;
    the decode's byte bound (every weight and the whole cache: a recurrent
    layer's state, a ring, the cross K/V) and one traced step; the peak.
    For an MoE config also the share of (token, slot) pairs the prefill
    drops at the config's capacity and the experts' bytes.
    ``with_model(model, batch)``, where given, runs before the weights are
    freed and returns more fields for the line.  Returns the batch served."""
    import contextlib

    import torch

    from repro_torch import serve_step as SS
    from repro_torch.data.tokens import token_batches
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TT

    dev = ctx.dev
    t_phase = time.perf_counter()
    full = lm_config(arch)
    cfg = lm_config(arch, layers)
    _free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = TT.init_model(cfg, seed=SEED, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    batch, _ = next(token_batches(cfg, B, prompt, seed=SEED, device=dev))
    P = SS.prefix_len(cfg, batch)
    L = P + prompt + gen + 1
    _, cache = SS.make_prefill(cfg, L)(model, batch)  # first calls; the ring after a prefill
    ring_prefill = _ring_ok(cache, cfg, P + prompt)
    SS.make_decode(cfg)(model, cache, batch["tokens"][:, -1], P + prompt)
    del cache
    torch.cuda.reset_peak_memory_stats()
    moe = bool(cfg.num_experts)
    with MOE.drop_log() if moe else contextlib.nullcontext([]) as drops:
        toks, pre_ms, step_ms, cache = lm_serve(model, batch, gen)
    peak = torch.cuda.max_memory_allocated() - base
    ring_end = _ring_ok(cache, cfg, P + prompt + gen - 1)
    check(ring_prefill and ring_end, f"[{phase}] {arch}: a ring's kpos is not what the positions "
          f"say (after the prefill: {ring_prefill}, at the end: {ring_end})")
    t0 = time.perf_counter()
    greedy = SS.greedy_generate(cfg, model, batch, steps=gen, cache_len=L)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    check(torch.equal(greedy, toks), f"[{phase}] {arch}: greedy_generate's tokens differ from the "
          "timed run's")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_padded,
          f"[{phase}] {arch}: a token outside the padded vocabulary")
    nbytes = lm_decode_bytes(model, cache, B)
    cache_bytes = _nbytes(cache)
    kernels, dev_ms, wall_ms = lm_decode_trace(model, cache, toks[:, -1], P + prompt + gen - 1)
    n_params = sum(p.numel() for p in model.parameters())
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    chunked = "attn_chunked" in cfg.layer_types()
    extra = {}
    if moe:
        dropped = sum(int(n) for n, _ in drops[:cfg.num_layers])  # the prefill: one call a layer
        pairs = sum(m for _, m in drops[:cfg.num_layers])
        ebytes = _expert_bytes(model)
        extra.update(experts=f"{cfg.num_experts} top-{cfg.experts_per_token}",
                     expert_std=f"{_expert_std(model):.6f}",
                     capacity_factor=cfg.expert_capacity_factor, moe_groups=cfg.moe_groups,
                     prefill_pairs_dropped=f"{dropped}/{pairs}",
                     prefill_drop_share=f"{dropped / pairs:.6f}", expert_bytes=ebytes,
                     experts_bound_ms=f"{ebytes / HBM_BYTES_PER_S * 1e3:.6f}")
    if chunked:
        extra["crossed_chunk"] = (f"at decode step {cfg.attn_chunk - P - prompt}"
                                  if P + prompt < cfg.attn_chunk <= P + prompt + gen - 2 else "no")
    del cache, greedy
    if with_model is not None:
        extra.update(with_model(model, batch))
    del model
    _free()
    dec = statistics.median(step_ms)
    say(phase, arch=cfg.name, cut=(f"num_layers {full.num_layers}->{cfg.num_layers}"
                                   if layers else "none"),
        layer_types=sorted(set(cfg.layer_types())), d_model=cfg.d_model,
        heads=f"{cfg.num_heads}/{cfg.num_kv_heads}", d_ff=cfg.d_ff, vocab_padded=cfg.vocab_padded,
        attn_chunk=cfg.attn_chunk, softcap=cfg.logit_softcap, params=n_params,
        weight_bytes=wbytes, init_s=f"{init_s:.3f}", peak_bytes_init=init_peak, batch=B, prefix=P,
        encoder_frames=cfg.encoder_seq if cfg.is_encoder_decoder else 0, prompt=prompt,
        generated=gen, prefill_ms=f"{pre_ms:.6f}",
        prefill_tokens_per_s=f"{B * (P + prompt) / pre_ms * 1e3:.1f}",
        decode_ms_per_step=f"{dec:.6f}",
        decode_ms_min_max=[f"{min(step_ms):.6f}", f"{max(step_ms):.6f}"],
        decode_tokens_per_s=f"{B / dec * 1e3:.1f}", cache_bytes=cache_bytes,
        decode_bytes=nbytes, decode_bound_ms=f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f}",
        decode_kernels=kernels, decode_device_ms=f"{dev_ms:.6f}",
        decode_traced_wall_ms=f"{wall_ms:.6f}", decode_device_busy=f"{dev_ms / wall_ms:.3f}",
        greedy_generate_s=f"{greedy_s:.3f}", greedy_equal=True, peak_bytes_serving=peak,
        ring_kpos=("exact after the prefill and at the end" if chunked
                   else "none (no attn_chunked layer)"), **extra,
        phase_s=f"{time.perf_counter() - t_phase:.1f}", card=ctx.smi)
    return batch


def lm_mlstm_check(ctx) -> None:
    """[lm-rec-serve] ``mlstm_chunkwise`` (chunks of 128) against the
    sequential cell on the card at xlstm's widths (LM_MLSTM_CHECK), on
    ``tests/test_mlstm_chunked.py``'s kind of inputs drawn from SEED, TF32
    off: h and C within the reference's 1e-4 (rtol and atol), m within
    1e-5; both timed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import mlstm_chunked as MC
    from repro_torch.models import recurrent as R

    t_phase = time.perf_counter()
    B, S, H, dh = LM_MLSTM_CHECK
    g = torch.Generator(device=ctx.dev).manual_seed(SEED)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=ctx.dev)

    q, k, v = draw(B, S, H, dh), draw(B, S, H, dh) / math.sqrt(dh), draw(B, S, H, dh)
    li, lf = draw(B, S, H), F.logsigmoid(draw(B, S, H) + 1.0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        (hc, (Cc, nc, mc)), ms_c = _events_ms(lambda: MC.mlstm_chunkwise(q, k, v, li, lf, chunk=128))
        (hs, (Cs, ns, ms)), ms_s = _events_ms(lambda: R.mlstm_sequential(q, k, v, li, lf))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    def off(a, b, tol):
        return ((a - b).abs() - tol * (1 + b.abs())).max().item()

    worst = {"h": off(hc, hs, LM_MLSTM_TOL), "C": off(Cc, Cs, LM_MLSTM_TOL),
             "n": off(nc, ns, LM_MLSTM_TOL), "m": off(mc, ms, 1e-5)}
    check(all(w <= 0 for w in worst.values()), f"[lm-rec-serve] mlstm_chunkwise off the sequential "
          f"form past the reference's tolerances: {worst}")
    say("lm-rec-serve", check="mlstm_chunkwise vs sequential", shape=[B, S, H, dh], chunk=128,
        tf32=False, max_abs_h=f"{(hc - hs).abs().max().item():.3e}",
        max_abs_C=f"{(Cc - Cs).abs().max().item():.3e}", max_abs_m=f"{(mc - ms).abs().max().item():.3e}",
        tol=LM_MLSTM_TOL, chunkwise_ms=f"{ms_c:.3f}", sequential_ms=f"{ms_s:.3f}",
        phase_s=f"{time.perf_counter() - t_phase:.1f}")


def lm_family_train_phase(ctx, phase: str, arch: str, layers, B: int, S: int, steps: int,
                          resume: bool = False) -> None:
    """[lm-rec-train] / [lm-encdec] / [lm-moe-train]: a config at its full
    width (the depth cut to ``layers`` where given) at train_4k's sequence S
    (a vision stub's patches inside it, as ``launch/shapes.py`` counts
    them), bf16 parameters from SEED, the config's optimizer, microbatches
    and remat: ``steps`` steps timed and one more traced; with ``resume``,
    the state saved after half the steps, loaded onto the card and the rest
    run from its data cursor, bitwise the uninterrupted run.  Prints, for
    an sLSTM config, the share of the traced step's launches; for an MoE
    config, the load-balance term before and after the steps."""
    import torch

    from repro_torch import ckpt
    from repro_torch.data.tokens import token_batches
    from repro_torch.models import transformer as TT
    from repro_torch.training import train_step as TS
    from repro_torch.uda import tree_leaves, tree_map

    dev = ctx.dev
    t_phase = time.perf_counter()
    full = lm_config(arch)
    cfg = lm_config(arch, layers)
    step = TS.make_train_step(cfg, lr=LM_TRAIN_LR)
    S_txt = S - (cfg.vis_tokens if cfg.frontend == "vision_stub" else 0)
    _free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt = TS.init_train_state(cfg, seed=SEED, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = _nbytes(model.params) + _nbytes(list(opt[1:]))
    shapes = [(t.shape, t.dtype) for t in tree_leaves(model.params)]
    batches = token_batches(cfg, B, S_txt, seed=SEED, device=dev)
    if cfg.num_experts:
        aux_probe = next(token_batches(cfg, B // cfg.train_microbatches, S_txt, seed=SEED + 1,
                                       device=dev))[0]["tokens"]
        aux0 = lm_moe_aux(model, aux_probe)
    half = steps // 2 if resume else steps
    model, opt, rows, cursor = lm_train_steps(step, model, opt, batches, half)
    path = ctx.work / f"{arch}_train.ckpt"
    if resume:
        t0 = time.perf_counter()
        ckpt.save_train_state(path, model.params, opt, half, cursor)
        save_s = time.perf_counter() - t0
        model, opt, more, _ = lm_train_steps(step, model, opt, batches, steps - half)
        rows += more
        snap = tree_map(lambda t: t.detach().to("cpu", copy=True), {"p": model.params, "o": opt})
    peak = torch.cuda.max_memory_allocated() - base
    # the loss need not fall in these few steps at lr 3e-3 from random
    # weights (an MoE cut's expert weights are drawn at std 1, a one-layer
    # stack's fan-in being 1, and kept in bf16 with no master copy, where
    # most of Adafactor's lr-sized updates round away); the steps are held
    # to the reference's in the tests
    lm_train_checks(phase, model, shapes, rows, falls=False)
    extra = {}
    if cfg.num_experts:
        extra.update(experts=f"{cfg.num_experts} top-{cfg.experts_per_token}",
                     expert_std=f"{_expert_std(model):.6f}",
                     aux_before_after=[f"{aux0:.6f}", f"{lm_moe_aux(model, aux_probe):.6f}"])
    probe = next(batches)[0]
    model, opt, traced = lm_train_trace(step, model, opt, probe)
    numbers = lm_train_numbers(model, rows, B, S, traced, base, peak)
    if "slstm" in cfg.layer_types():
        extra["slstm_forward_launch_share"] = f"{lm_slstm_share(model, probe):.3f}"
    del model, opt
    _free()
    if resume:
        t0 = time.perf_counter()
        params, o2, at, cursor = ckpt.load_train_state(path, snap["p"], snap["o"], device=dev)
        m2 = TT.Transformer(cfg, params).requires_grad_(True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        nbytes = path.stat().st_size
        path.unlink()
        del params
        m2, o2, _, _ = lm_train_steps(step, m2, o2, token_batches(cfg, B, S_txt, start=cursor,
                                                                  seed=SEED, device=dev),
                                      steps - half)
        same = all(torch.equal(a, b.cpu()) for a, b in zip(tree_leaves(snap),
                                                             tree_leaves({"p": m2.params, "o": o2})))
        check(at == half and same, f"[{phase}] {arch}: {half} steps, a checkpoint and "
              f"{steps - half} more differ from {steps} uninterrupted steps")
        del m2, o2, snap
        _free()
        extra.update(resume=f"{half}+save+load+{steps - half} bitwise", checkpoint_bytes=nbytes,
                     save_s=f"{save_s:.3f}", load_s=f"{load_s:.3f}")
    cuts = ([f"num_layers {full.num_layers}->{cfg.num_layers}"] if layers else []) + [
        f"batch 256->{B}"] + ([f"seq 4096->{S}"] if S != 4096 else [])
    say(phase, arch=cfg.name, cut=", ".join(cuts),
        d_model=cfg.d_model, layer_types=sorted(set(cfg.layer_types())), lr=LM_TRAIN_LR,
        optimizer=cfg.optimizer, steps=f"{steps}+1 traced", init_s=f"{init_s:.3f}",
        state_bytes=state_bytes, active_params=lm_active_params(cfg, shapes),
        text_tokens=S_txt, **numbers, **extra,
        phase_s=f"{time.perf_counter() - t_phase:.1f}", card=ctx.smi)


def lm_kernels(fn) -> int:
    """Kernels that ``fn()`` launches, from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cost import trace_summary

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return trace_summary(prof)["kernels"]


def lm_slstm_share(model, batch) -> float:
    """The sLSTM layers' share of the kernels one forward over ``batch``
    launches (no graph): each sLSTM block's kernels, counted alone on the
    same shape, over the whole forward's.  Under the train step's remat each
    layer's forward runs again, so the step's share is about the same."""
    import torch

    from repro_torch.models import recurrent as R

    cfg = model.cfg
    with torch.no_grad():
        total = lm_kernels(lambda: model.forward(batch))
        x = torch.zeros((*batch["tokens"].shape, cfg.d_model), dtype=torch.bfloat16,
                        device=batch["tokens"].device)
        layers = [p for p, lt in zip(model.layers, cfg.layer_types()) if lt == "slstm"]
        one = lm_kernels(lambda: R.slstm_train(layers[0], x, cfg))
    return len(layers) * one / total


def lm_cpu_grad_check(ctx, phase: str, archs, tokens) -> None:
    """[``phase``] ``archs``' smoke configs on the card against the CPU
    port at (batch, sequence) ``tokens``: one ``value_and_grad`` with
    float32 weights (TF32 off),
    every grad leaf within LM_CPU_TOL of its max|CPU grad| — or, for a leaf
    whose CPU float32 grad lies farther than LM_CPU_TOL / FLOOR_FACTOR from
    its float64 one (its float32 floor: xlstm's smoke weights; the sLSTM's
    ``bi``, whose exact gradient is 0), within FLOOR_FACTOR times that
    floor — two card runs bitwise, and the card's float64 grads within 1e-9
    of the largest CPU float64 grad (of the whole tree: ``bi``'s are
    rounding alone in float64 too)."""
    import torch

    from repro_torch.data.tokens import token_batches
    from repro_torch.models import transformer as TT
    from repro_torch.training import train_step as TS
    from repro_torch.uda import tree_leaves, tree_map

    dev = ctx.dev
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for a in archs:
            t_phase = time.perf_counter()
            scfg = lm_config(a).smoke()
            cpu = TT.init_model(scfg, seed=SEED, dtype=torch.float32, device="cpu")
            batch, _ = next(token_batches(scfg, *tokens, seed=SEED, device="cpu"))

            def grads(params, device, dtype):
                m = TT.Transformer(scfg, tree_map(lambda t: t.detach().to(device, dtype, copy=True),
                                                  params)).requires_grad_(True)
                b = {k: v.to(device, dtype) if v.is_floating_point() else v.to(device)
                     for k, v in batch.items()}
                (loss, _), g = TS.value_and_grad(m, scfg, b)
                return loss, tree_leaves(g)

            la, ga = grads(cpu.params, "cpu", torch.float32)
            lb, gb = grads(cpu.params, dev, torch.float32)
            lb2, gb2 = grads(cpu.params, dev, torch.float32)
            _, g64 = grads(cpu.params, "cpu", torch.float64)
            _, gd64 = grads(cpu.params, dev, torch.float64)
            twice = torch.equal(lb, lb2) and all(torch.equal(x, y) for x, y in zip(gb, gb2))
            rels = [lm_floor_rel(y.cpu(), x) for x, y in zip(ga, gb)]
            floors = [lm_floor_rel(x, e) for x, e in zip(ga, g64)]
            tols = [max(LM_CPU_TOL, FLOOR_FACTOR * f) for f in floors]
            scale64 = max(e.abs().max().item() for e in g64)
            rel64 = max((y.cpu() - e).abs().max().item() for y, e in zip(gd64, g64)) / scale64
            worst = max(range(len(rels)), key=lambda i: rels[i] / tols[i])
            check(twice, f"[{phase}] {a}: two card runs of the backward differ")
            check(rels[worst] <= tols[worst], f"[{phase}] {a}: a float32 grad leaf of the "
                  f"card off the CPU port's by {rels[worst]:.3e} (tolerance {tols[worst]:.3e})")
            check(rel64 <= 1e-9, f"[{phase}] {a}: the card's float64 grads off the CPU "
                  f"port's by {rel64:.3e}")
            held = [r for r, f in zip(rels, floors) if FLOOR_FACTOR * f <= LM_CPU_TOL]
            say(phase, check="card vs CPU port", arch=scfg.name, config="smoke()",
                tf32=False, tokens=list(tokens),
                loss_cpu_card=[f"{la.item():.6f}", f"{lb.item():.6f}"],
                grad_rel_f32_max=f"{max(held, default=0.0):.3e}", tol=LM_CPU_TOL,
                leaves_at_tol=f"{len(held)}/{len(rels)}", leaves_at_floor=len(rels) - len(held),
                worst_rel_over_tol=f"{rels[worst] / tols[worst]:.3f}",
                grad_rel_f64=f"{rel64:.3e}", card_twice="bitwise",
                phase_s=f"{time.perf_counter() - t_phase:.1f}")
            del cpu, ga, gb, gb2, g64, gd64
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    _free()


def rec_phases(ctx) -> None:
    """The recurrent, encoder-decoder and vision phases, before the TPC-H
    data exists (recurrentgemma's training takes about 43 GB of state):
    [lm-rec-serve] for each of LM_REC_SERVE's configs with its incremental
    checks and the chunkwise mLSTM on the card, then [lm-rec-train], then
    [lm-encdec]."""
    for arch, B, prompt, gen in LM_REC_SERVE:
        batch = lm_family_serve_phase(ctx, "lm-rec-serve", arch, B, prompt, gen)
        lm_incremental_checks(ctx, "lm-rec-serve", lm_config(arch, LM_REC_INCR_LAYERS.get(arch)),
                              batch)
        del batch
    lm_mlstm_check(ctx)
    for arch, layers, B, S, steps in LM_REC_TRAIN:
        lm_family_train_phase(ctx, "lm-rec-train", arch, layers, B, S, steps,
                              resume=arch == "xlstm_125m")
    lm_cpu_grad_check(ctx, "lm-rec-train", LM_REC_ARCHS, LM_REC_CPU)
    for arch, B, prompt, gen in LM_ENCDEC_SERVE:
        batch = lm_family_serve_phase(ctx, "lm-encdec", arch, B, prompt, gen)
        lm_incremental_checks(ctx, "lm-encdec", lm_config(arch), batch)
        del batch
        lm_family_train_phase(ctx, "lm-encdec", arch, None, *LM_ENCDEC_TRAIN)


#: the LM phases run in a process of their own: (argument, phases, seconds
#: allowed, what the line names)
CHILDREN = ((MOE_CHILD, moe_phases, MOE_CHILD_S, "lm-moe"),
            (REC_CHILD, rec_phases, REC_CHILD_S, "lm-rec"))


def child(work: Path, phases) -> None:
    """``phases(ctx)`` in this process, on the card, its scratch files
    under ``work``."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    work.mkdir(parents=True, exist_ok=True)
    phases(types.SimpleNamespace(dev=torch.device(DEVICE), smi=smi, work=work))


def dryrun_child(out: Path, jobs: int) -> None:
    """The dry run's process (no card): ``repro_torch.dryrun --all`` on the
    single and the multi mesh, ``jobs`` cells at a time, then
    ``repro_torch.hillclimb`` on HILLCLIMB's cell, each a subprocess writing
    under ``out``; ``out/summary.json`` gets their exit codes and seconds,
    and the host's monotonic clock at the end."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    summary = {"rc": {}, "seconds": {}}
    for mesh in ("single", "multi"):
        t0 = time.perf_counter()
        summary["rc"][mesh] = subprocess.run(
            [sys.executable, "-m", "repro_torch.dryrun", "--all", "--force", "--mesh", mesh,
             "--jobs", str(jobs), "--out", str(out / "cells")],
            cwd=str(ROOT), env=env, timeout=DRYRUN_CHILD_S).returncode
        summary["seconds"][mesh] = time.perf_counter() - t0
    arch, shape, mesh = HILLCLIMB
    t0 = time.perf_counter()
    summary["rc"]["hillclimb"] = subprocess.run(
        [sys.executable, "-m", "repro_torch.hillclimb", arch, shape, "--mesh", mesh,
         "--label", "chip", "--out", str(out / "hillclimb")],
        cwd=str(ROOT), env=env, timeout=DRYRUN_CHILD_S).returncode
    summary["seconds"]["hillclimb"] = time.perf_counter() - t0
    summary["end"] = time.monotonic()
    (out / "summary.json").write_text(json.dumps(summary))


def dryrun_start(out: Path):
    """Starts :func:`dryrun_child` in a niced process of its own, its output
    to ``out/log.txt``; returns (the process, its start on the host's
    monotonic clock)."""
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    log = open(out / "log.txt", "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), DRYRUN_CHILD,
                             str(out), str(DRYRUN_JOBS)],
                            stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True, preexec_fn=lambda: os.nice(19))
    log.close()
    _STARTED.append(proc)
    return proc, time.monotonic()


def _stop(proc) -> None:
    """Ends ``proc`` and every process it started (its session)."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, 9)
        except ProcessLookupError:
            pass
        proc.wait()


def dryrun_phase(ctx, proc, t_start: float, out: Path) -> None:
    """[dryrun] every cell of both meshes OK or SKIP (the dry run's process
    waited for); [hillclimb] its cell's roofline terms against the H100
    constants; [dryrun-card] DRYRUN_CARD's cell on a (data=1, model=1)
    mesh against the card: ``argument_bytes`` equal to the bytes of the
    same parameters, optimizer state and batch allocated on the card, the
    loop-scaled ``meta`` flop count equal to the count of the real step
    there, that count against :func:`lm_train_flops`, and ``temp_bytes``
    against the step's peak above what was allocated before it; then
    [contracts]: the port's linter over its default targets, 0 violations."""
    import dataclasses

    import torch

    from repro_torch import cost as CT
    from repro_torch import dryrun as DR
    from repro_torch.configs import list_archs
    from repro_torch.mesh import HBM_PER_CHIP
    from repro_torch.shapes import SHAPES

    t_wait = time.perf_counter()
    try:
        rc = proc.wait(timeout=2 * DRYRUN_CHILD_S + 300)
    except subprocess.TimeoutExpired:
        _stop(proc)
        fail("[dryrun] the dry run's process did not finish")
    waited = time.perf_counter() - t_wait
    log = (out / "log.txt").read_text()
    check(rc == 0, f"[dryrun] the dry run's process exited with {rc}: {log[-3000:]}")
    summary = json.loads((out / "summary.json").read_text())
    for mesh in ("single", "multi"):
        recs = {}
        for arch in list_archs():
            for shape in SHAPES:
                cell = f"{arch}.{shape}.{mesh}"
                f = out / "cells" / f"{cell}.json"
                check(f.exists(), f"[dryrun] {cell} wrote no record")
                recs[cell] = json.loads(f.read_text())
        bad = {c: r.get("stderr", "")[-400:] for c, r in recs.items()
               if r["status"] not in ("OK", "SKIP")}
        check(not bad and summary["rc"][mesh] == 0, f"[dryrun] {mesh}: failed cells {bad}")
        ok = {c: r for c, r in recs.items() if r["status"] == "OK"}
        peak = {c: r["memory"]["peak_estimate"] for c, r in ok.items()}
        say("dryrun", mesh=mesh, chips=next(iter(ok.values()))["chips"], cells=len(recs),
            ok=len(ok), skip=len(recs) - len(ok), fail=0,
            skipped=sorted(c.rsplit(".", 1)[0] for c, r in recs.items() if r["status"] == "SKIP"),
            over_hbm=sorted(c.rsplit(".", 1)[0] for c, b in peak.items() if b > HBM_PER_CHIP),
            max_peak_gb={max(peak, key=peak.get).rsplit(".", 1)[0]: f"{max(peak.values()) / 1e9:.3f}"},
            tflops_per_device={c.rsplit(".", 1)[0]: f"{r['flops_per_device'] / 1e12:.6g}"
                               for c, r in ok.items()},
            peak_gb={c.rsplit(".", 1)[0]: f"{b / 1e9:.3f}" for c, b in peak.items()},
            count_s_max=f"{max(r['count_s'] for r in ok.values()):.3f}",
            seconds=f"{summary['seconds'][mesh]:.3f}", card=ctx.smi)
    check(summary["rc"]["hillclimb"] == 0, "[hillclimb] exited non-zero")
    arch, shape, mesh = HILLCLIMB
    hc = json.loads((out / "hillclimb" / f"{arch}.{shape}.chip.json").read_text())
    check(all(math.isfinite(hc[k]) and hc[k] >= 0 for k in ("compute_s", "memory_s", "collective_s")),
          "[hillclimb] a non-finite roofline term")
    say("hillclimb", cell=hc["cell"], compute_s=f"{hc['compute_s']:.6g}",
        memory_s=f"{hc['memory_s']:.6g}", collective_s=f"{hc['collective_s']:.6g}",
        dominant=hc["dominant"], flops_per_device=f"{hc['flops_per_device']:.6e}",
        bytes_per_device=f"{hc['bytes_per_device']:.6e}",
        collective_bytes={k: f"{v:.6e}" for k, v in hc["collective_bytes"].items()},
        peak_gb=f"{hc['peak_gb']:.3f}", peak_flops_bf16=BF16_FLOPS_PER_S,
        hbm_bw=HBM_BYTES_PER_S, top_bytes=[(k[:60], f"{v:.3e}") for k, v in hc["top_bytes"][:5]],
        seconds=f"{summary['seconds']['hillclimb']:.3f}", card=ctx.smi)
    beside = list(dict.fromkeys(p for p, t in _SAID if t_start <= t <= summary["end"]))
    say("dryrun-wait", process_s=f"{summary['end'] - t_start:.3f}",
        waited_at_the_end_s=f"{waited:.3f}", jobs=DRYRUN_JOBS,
        lines_printed_beside_it=beside, card=ctx.smi)

    # -- one cell against the card
    t0 = time.perf_counter()
    arch, shape, layers, batch = DRYRUN_CARD
    cfg0 = lm_config(arch)
    cfg = dataclasses.replace(cfg0, num_layers=layers)
    one = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    cell = DR.build_cell(arch, shape, one, cfg=cfg, batch=batch)
    c_meta, mem, meta_s = DR.measure(cell, one)
    _free()
    base0 = torch.cuda.memory_allocated()
    args = DR.materialize(cell, ctx.dev, seed=SEED)
    torch.cuda.synchronize()
    held = list(CT._tensors(tuple(args[1:]))) + list(args[0].parameters())
    alloc = sum(t.untyped_storage().nbytes() for t in held)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    _, c_card = CT.count(cell.step, *args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    check(mem["argument_bytes"] == alloc,
          f"[dryrun-card] argument_bytes {mem['argument_bytes']} != allocated {alloc}")
    check(c_card.cost.flops == c_meta.cost.flops,
          f"[dryrun-card] card flops {c_card.cost.flops} != meta {c_meta.cost.flops}")
    formula = lm_train_flops(args[0], batch, SHAPES[shape]["seq"])
    remat = (6 + 2 * (cfg.remat != "none")) / 6
    rel = c_card.cost.flops / (formula * remat) - 1
    check(abs(rel) <= DRYRUN_TRAIN_RTOL,
          f"[dryrun-card] flops {c_card.cost.flops:.6e} vs lm_train_flops x {remat:.4f}: {rel:+.4f}")
    say("dryrun-card", cell=f"{arch}.{shape}", mesh="(data=1, model=1)",
        cut={"layers": f"{cfg0.num_layers} -> {layers}",
             "batch": f"{SHAPES[shape]['batch']} -> {batch}"},
        microbatches=cell.microbatches, argument_bytes=mem["argument_bytes"],
        allocated_bytes=alloc, allocated_by_the_allocator=base - base0, bytes_equal=True,
        flops_meta=f"{c_meta.cost.flops:.9e}", flops_card=f"{c_card.cost.flops:.9e}",
        flops_equal=True, matmul_flops=f"{c_card.matmul_flops():.9e}",
        bytes_meta=f"{c_meta.cost.bytes:.9e}", bytes_card=f"{c_card.cost.bytes:.9e}",
        lm_train_flops=f"{formula:.9e}", remat_factor=f"{remat:.4f}", vs_formula=f"{rel:+.5f}",
        formula_leaves_out="transcendental ops and the recurrences' cells; attention as a "
                           "full square (the port visits a triangle of key blocks and "
                           "recomputes each in the backward)",
        temp_bytes=mem["temp_bytes"], peak_above_base=peak,
        temp_over_peak=f"{mem['temp_bytes'] / max(peak, 1):.4f}",
        meta_count_s=f"{meta_s:.3f}", card_counted_step_s=f"{step_s:.3f}",
        seconds=f"{time.perf_counter() - t0:.3f}", card=ctx.smi)
    del args, held, c_card
    _free()

    # -- the port's contract linter (the reference's over src/repro_torch is
    # a CPU test: tests/test_contracts.py::test_repo_lints_clean)
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    port = subprocess.run([sys.executable, "-m", "repro_torch.contracts"], cwd=str(ROOT),
                          env=env, capture_output=True, text=True)
    check(port.returncode == 0 and "contracts: OK" in port.stdout,
          f"[contracts] the port's linter: {port.stdout[-2000:]}{port.stderr[-1000:]}")
    say("contracts", port=port.stdout.strip().splitlines()[-1],
        seconds=f"{time.perf_counter() - t0:.3f}", card=ctx.smi)


def median_ms(fn, reps):
    """Median ms of ``reps`` calls of ``fn`` by CUDA events, after one
    warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def phases(fn, split, reps=3):
    """Device ms per call of the grids named in ``split`` ({key: (a part of
    the grid's kernel name, launches per call)}) and of the other kernels
    the call launches (``other_ms``), from a torch.profiler trace of
    ``reps`` calls.  A grid's time is the mean of its kernels in the trace
    times its launches per call (the trace may miss a launch: ``captured``
    counts, grid by grid, the kernels it holds of those launched); "not
    measured" where it holds none.  The trace records host activity too, as
    olabench's does: without it the kernels that ctypes launches are not
    read; only device events are summed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cost import trace_summary

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    tot, n = dict.fromkeys(split, 0.0), dict.fromkeys(split, 0)
    other = 0.0
    for name, ms, count in trace_summary(prof, top=None)["top"]:   # device entries
        key = next((k for k, (part, _) in split.items() if part in name), None)
        if key is None:
            other += ms
            continue
        tot[key] += ms
        n[key] += count
    out = {k: (f"{tot[k] / n[k] * per:.6f}" if n[k] else "not measured")
           for k, (_, per) in split.items()}
    out["other_ms"] = f"{other / reps:.6f}"
    out["captured"] = ("+".join(str(n[k]) for k in split) + "/"
                       + "+".join(str(per * reps) for _, per in split.values()))
    return out


def group_split(grids):
    """The group step's two grids, each launched ``grids`` times per call
    (once per tile of chunks): phase 1 ``group_partials_kernel``, phase 2
    ``group_fold_kernel``."""
    return {"phase1_ms": ("group_partials", grids), "phase2_ms": ("group_fold", grids)}


def table_entries(fn) -> list:
    """The mean entries of a chunk table, a group member each, in launch
    order, as one more call of ``fn`` leaves them: the last offset of each
    table of the last tile, read from the scratch the wrappers allocate
    (``ops.group_step_scratch``, kept for the read)."""
    import torch

    from repro_torch.kernels import ops

    kept = []
    real = ops.group_step_scratch

    def keep(P_, C_, L_, A, G, tile, device):
        t = real(P_, C_, L_, A, G, tile, device)
        kept.append((t, P_, C_, L_, A, G, min(tile, C_)))
        return t

    ops.group_step_scratch = keep
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        ops.group_step_scratch = real
    out = []
    for t, P_, C_, L_, A, G, tile in kept:
        ct = C_ - (-(-C_ // tile) - 1) * tile  # the last tile's chunks
        words = ops.group_step_words(L_, A, G)
        W = -(-G // (32 * ops.group_step_span(L_, A, G)))
        last = t[:P_ * ct * words].view(P_ * ct, words)[:, W].contiguous()
        out.append(round(last.view(torch.int32).double().mean().item(), 3))
    return out


def group_step_rows() -> None:
    """``python3 chip_smoke.py --group-step``: the kernel table's group-step
    rows alone, each first held against its plain version (counters exact,
    sums within SUM_RTOL, repeats and every bundle member bitwise its solo
    launch): K1 Q15 at SF 100, olabench's report bundle at SF 100 and SF
    10, its sf100-report-join K3 bundle, and K1 Q1-small, the 2^13 buckets
    and K3 Q3 on one round-slice of lineitem made on the card (P x C/ROUNDS
    x L rows).  Each row gives the median ms of CUDA events, the two grids'
    device ms (``phase1_ms``, ``phase2_ms``) and the mean entries of a
    group member's chunk table (``entries``)."""
    import torch

    import repro_torch as T
    from repro_torch import randomize, scan
    from repro_torch.data import tpch
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import fused_agg as FK

    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say("device", name=torch.cuda.get_device_name(0), smi=repr(smi), root=ROOT.name)
    t0 = time.perf_counter()
    secs = _build.build_all(("fused_agg", "group_agg"))
    say("build", seconds=f"{time.perf_counter() - t0:.3f}",
        per_source={k: round(v, 3) for k, v in secs.items()})

    per = C // ROUNDS
    rows = P * per * L
    cols = tpch.generate_lineitem(rows, num_suppliers=tpch.Q1_LARGE_SUPPLIERS,
                                  seed=SEED, device=dev)
    cols["orderkey"] = tpch.generate_orders_fk(rows, seed=SEED, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    sl = randomize.pack_partitions(randomize.randomize_global(cols, gen, P), chunk_len=L)
    del cols
    d = float(rows)
    q1s, q1l = q6_q1s(d)[1], q1_large(d)
    orders = tpch.orders_table(rows // 4, seed=SEED + 7, device=dev)
    q3 = T.make_join_groupby_gla(tpch.q6_func, tpch.q1_cond, tpch.orderkey, *orders,
                                 num_groups=tpch.NUM_SEGMENTS, d_total=d, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)

    def carries(G, A):
        return (torch.rand((P, G, A), generator=g, device=dev) * 1e3,
                torch.rand((P, G, A), generator=g, device=dev) * 1e6,
                torch.randint(0, 1000, (P, G), generator=g, device=dev).float())

    def compare(name, got, want):
        """Each output a group triple (counters last) or a scalar member's
        [P, 2A+1] state (the counter last): counters exact, sums within
        SUM_RTOL of the plain version.  The largest error."""
        err = 0.0
        for i, (a, b) in enumerate(zip(got, want)):
            if isinstance(a, torch.Tensor):
                k = a.shape[-1] - 1
                a, b = (a[..., :k], a[..., k]), (b[..., :k], b[..., k])
            check(torch.equal(a[-1], b[-1]), f"{name}: output {i}'s counter differs")
            for x, y in zip(a[:-1], b[:-1]):
                check(torch.isfinite(x).all().item(), f"{name}: output {i} not finite")
                tol = SUM_RTOL * y.abs().max().item()
                check(torch.allclose(x, y, rtol=SUM_RTOL, atol=tol),
                      f"{name}: output {i} off by {(x - y).abs().max().item():.3e}")
                err = max(err, (x - y).abs().max().item())
        return err

    def same(a, b):
        a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def k1_group(vals, w, gids, G):
        A = vals.shape[-1]
        args = (vals, w, gids, *carries(G, A))
        return (lambda: [FK.group_round_step(*args)], lambda: [ref.group_round_step(*args)],
                [lambda: FK.group_round_step(*args)], [(A, G)], vals.shape[1])

    def k1_bundle(margs):
        solo = [(lambda m=m: FK.scalar_round_step(m[0], m[1], m[3])) if m[2] is None
                else (lambda m=m: FK.group_round_step(*m)) for m in margs]
        return (lambda: FK.bundle_round_step(margs), lambda: ref.bundle_round_step(margs),
                solo, [(m[0].shape[-1], m[5].shape[-1]) for m in margs if m[2] is not None],
                margs[0][1].shape[1])

    def k3(members):
        solo = [lambda m=m: ops.group_agg(*m[:3], num_groups=m[3], block_rows=L)
                for m in members]
        run = ((lambda: [solo[0]()]) if len(members) == 1
               else (lambda: ops.group_agg_bundle(members, block_rows=L)))
        return (run, lambda: [ref.group_agg(*m, L) for m in members], solo,
                [(m[0].shape[-1], m[3]) for m in members], members[0][1].shape[1] // L)

    def q15(chunks):
        G = Q15_SUPPLIERS
        vals = torch.rand((P, chunks, L, 1), generator=g, device=dev) * 1e4
        w = (torch.rand((P, chunks, L), generator=g, device=dev) < 0.04).float()
        gids = torch.randint(0, G, (P, chunks, L), generator=g, device=dev,
                             dtype=torch.int32)
        return k1_group(vals, w, gids, G)

    def projected(gla):
        vals, w, gids = FK.project(gla.fused, sl)
        return k1_group(vals, w, gids, gla.fused.num_groups)

    cases = (("fused_round_step/group[Q15]", lambda: q15(Q15_CHUNKS)),
             ("fused_round_step/bundle[report-sf100]",
              lambda: k1_bundle(report_bundle(dev, *REPORT_SLICES["sf100"], SEED + 15))),
             ("fused_round_step/bundle[report-sf10]",
              lambda: k1_bundle(report_bundle(dev, *REPORT_SLICES["sf10"], SEED + 15))),
             ("group_agg_bundle[report-join-sf100]",
              lambda: k3(join_bundle(dev, Q15_CHUNKS, SEED + 35))),
             ("fused_round_step/group[G=4]", lambda: projected(q1s)),
             ("fused_round_step/group[G=8192]", lambda: projected(q1l)),
             ("group_agg[Q3]", lambda: k3([scan.kernel_operands(q3, sl)])))
    for name, make in cases:
        run, plain, solo, members, chunks = make()
        got, again = run(), run()
        torch.cuda.synchronize()
        check(all(same(a, b) for a, b in zip(got, again)), f"{name}: repeat not bitwise")
        check(all(same(a, f()) for a, f in zip(got, solo)),
              f"{name}: a member differs from its solo launch")
        err = compare(name, got, plain())
        del got, again
        nt = -(-chunks // ops.group_step_tile(chunks, L, members))
        split = group_split(nt)
        if name.startswith("fused_round_step/bundle"):
            split.update(scalar_partials_ms=("bundle_partials", 1),
                         scalar_fold_ms=("bundle_fold", 1))
        say("time", kernel=name, ms=f"{median_ms(run, 10):.6f}", max_abs_err=err,
            members=members, spans=[ops.group_step_span(L, A, G) for A, G in members],
            tiles=nt, entries=table_entries(run), **phases(run, split),
            repeat="bitwise-equal", members_vs_solo="bitwise-equal")
        torch.cuda.empty_cache()
    print(smi, flush=True)
    print(json.dumps({"ok": True, "group_step_rows": len(cases)}), flush=True)


def run(work: Path) -> None:
    import torch


    import repro_torch as T
    from repro_torch import scan
    from repro_torch.data import encodings as ENC
    from repro_torch.data import source as DS
    from repro_torch.data import tpch
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode as KD
    from repro_torch.kernels import fused_agg as FK
    from repro_torch.uda import tree_map

    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say("device", name=torch.cuda.get_device_name(0), torch=torch.__version__,
        cuda=torch.version.cuda, smi=repr(smi))

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build_all()
    say("build", seconds=f"{time.perf_counter() - t0:.3f}",
        per_source={k: round(v, 3) for k, v in secs.items()})
    for src in _build.SOURCES:
        for line in _build.lib_path(src).with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas[{src}]:", line.strip())

    # -- the dry run's process, on the host beside the phases below
    dry_out = ROOT / "build" / "chip_smoke_dryrun"  # git-ignored; deleted at the end
    dry, t_dry = dryrun_start(dry_out)

    # -- the MoE phases ([lm-moe-serve], [lm-moe-train]), then the
    # recurrent, encoder-decoder and vision phases ([lm-rec-serve],
    # [lm-rec-train], [lm-encdec]), each in a process of its own while the
    # card holds nothing else: their weights and states take 43-69 GB
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    for flag, _, limit, name in CHILDREN:
        t0 = time.perf_counter()
        sys.stdout.flush()
        rc = subprocess.run([sys.executable, str(Path(__file__).resolve()), flag,
                             str(work / name)], env=env, timeout=limit).returncode
        check(rc == 0, f"the [{name}] phases' process exited with {rc}")
        say(name, process_s=f"{time.perf_counter() - t0:.3f}")

    # -- data: generated, globally randomized and packed on the device ------
    t0 = time.perf_counter()
    shards = make_data(dev)
    torch.cuda.synchronize()
    check(tuple(shards["_mask"].shape) == (P, C, L), "unexpected shard shape")
    gib = sum(v.numel() * v.element_size() for v in shards.values()) / 2**30
    say("data", rows=ROWS, shape=(P, C, L), resident_gib=f"{gib:.3f}",
        seconds=f"{time.perf_counter() - t0:.3f}")
    flat = {k: v.reshape(-1) for k, v in shards.items()}

    # -- the out-of-core copies: the streamed queries' columns on the host,
    # written as an npy and an encoded directory and read back by mmap ----
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    say("disk", path=str(work.relative_to(ROOT)),
        free_gb=f"{shutil.disk_usage(work).free / 1e9:.3f}",
        needed_gb=f"{ROWS * (28 + 13.25) / 1e9:.3f}")
    t0 = time.perf_counter()
    host = {k: shards[k].cpu().numpy() for k in STREAM_COLS}
    t_host = time.perf_counter() - t0
    encs = {k: ENC.dict_encoding_for(host[k]) for k in ("discount", "quantity", "tax")}
    encs.update(shipdate=ENC.BitPackedEncoding(16), rfls=ENC.BitPackedEncoding(2))
    t0 = time.perf_counter()
    npy_src = DS.NpyMmapSource(DS.NpyMmapSource.save(host, work / "npy"))
    t_npy = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc_src = DS.EncodedSource(DS.EncodedSource.save(host, work / "encoded", encs))
    t_enc = time.perf_counter() - t0
    del host
    sizes = {d: sum(f.stat().st_size for f in (work / d).iterdir()) for d in ("npy", "encoded")}
    check(enc_src.spec == npy_src.spec, "encoded and npy sources differ in spec")
    check(enc_src.fingerprint() == npy_src.fingerprint(),
          "encoded and npy fingerprints differ")
    say("sources", columns=list(STREAM_COLS), to_host_s=f"{t_host:.3f}",
        npy_bytes=sizes["npy"], npy_write_s=f"{t_npy:.3f}",
        encoded_bytes=sizes["encoded"], encode_and_write_s=f"{t_enc:.3f}",
        encodings={k: type(e).__name__ + (f"({e.code_dtype}, {len(e.values)} values)"
                                          if hasattr(e, "values") else f"({e.bits} bits)")
                   for k, e in enc_src.encodings},
        fingerprint=npy_src.fingerprint()[:16])

    d = float(ROWS)
    q6, q1s = q6_q1s(d)
    q1l = q1_large(d)
    # Q3: lineitem ⋈ orders (rows/4 orders, as the reference's q3_scenario);
    # its probe tables are far past the reference's fused budget -> K3
    orders = tpch.orders_table(ROWS // 4, seed=SEED + 7, device=dev)
    q3 = T.make_join_groupby_gla(
        tpch.q6_func, tpch.q1_cond, tpch.orderkey, *orders,
        num_groups=tpch.NUM_SEGMENTS, d_total=d, device=dev)
    # supplier ⋈ nation (paper §5.4): a small dimension -> fused K1
    nation = tpch.supplier_nation_table(tpch.Q1_LARGE_SUPPLIERS, seed=SEED + 11,
                                        device=dev)
    jn = T.make_join_groupby_gla(
        tpch.q1_func, tpch.q1_cond, tpch.q1_group_large, *nation,
        num_groups=tpch.NUM_NATIONS, d_total=d, num_aggs=4, device=dev)
    q6k = q6.with_(fused=None)  # the legacy scalar path (K4)
    check(not FK.fused_available(q3) and FK.fused_available(jn),
          "join routing differs from the reference's probe-budget rule")
    say("joins", q3_probe_bytes=FK.probe_bytes(q3), nation_probe_bytes=FK.probe_bytes(jn),
        budget=FK.REFERENCE_PROBE_BUDGET_BYTES)

    # -- 2. every kernel against its plain version, at the main path's shapes
    per = C // ROUNDS
    sl = {k: v[:, :per] for k, v in shards.items()}  # one round-slice
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)

    def compare(name, got, want, exact_idx):
        """Counters (``exact_idx`` of the outputs) exact; sums within
        SUM_RTOL, with atol = SUM_RTOL * max|plain|."""
        err = 0.0
        for i, (a, b) in enumerate(zip(got, want)):
            check(torch.isfinite(a).all().item(), f"{name}: non-finite output {i}")
            diff = (a - b).abs().max().item()
            err = max(err, diff)
            if i in exact_idx:
                check(torch.equal(a, b), f"{name}: counter output {i} differs")
            else:
                tol = SUM_RTOL * b.abs().max().item()
                check(torch.allclose(a, b, rtol=SUM_RTOL, atol=tol),
                      f"{name}: output {i} off by {diff:.3e}")
        return err

    def twice(fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              "repeat run is not bitwise-equal")
        return a

    checks = {}
    vals6, w6, _ = FK.project(q6.fused, sl)
    carry = torch.cat([torch.rand((P, 2), generator=g, device=dev) * 1e3,
                       torch.randint(0, 100, (P, 1), generator=g, device=dev).float()], 1)
    got = twice(lambda: FK.scalar_round_step(vals6, w6, carry))
    want = (ref.scalar_round_step(vals6, w6, carry),)
    A = 1
    checks["fused_round_step/scalar"] = compare(
        "K1 scalar", (got[0][:, :2 * A], got[0][:, 2 * A]),
        (want[0][:, :2 * A], want[0][:, 2 * A]), {1})
    # a view one float past a 16-byte boundary takes the 4-byte loads, the
    # aligned tensors the 16-byte ones: the same rows per thread, same bits
    mis = [torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape).copy_(t)
           for t in (vals6, w6)]
    check(torch.equal(FK.scalar_round_step(*mis, carry), got[0]),
          "K1 scalar: a misaligned view differs from the aligned tensors")
    del mis
    say("check", kernel="fused_round_step/scalar", shape=tuple(vals6.shape),
        max_abs_err=checks["fused_round_step/scalar"], repeat="bitwise-equal",
        misaligned_view="bitwise-equal")

    group_inputs = {}
    for label, gla in (("G=4", q1s), ("G=8192", q1l), ("G=1", q1s)):
        vals, w, gids = FK.project(gla.fused, sl)
        G = gla.fused.num_groups
        if label == "G=1":  # every row in one group: one run of L rows per chunk
            gids, G = torch.zeros_like(gids), 1
        cs = torch.rand((P, G, 4), generator=g, device=dev) * 1e3
        cq = torch.rand((P, G, 4), generator=g, device=dev) * 1e6
        cm = torch.randint(0, 1000, (P, G), generator=g, device=dev).float()
        got = twice(lambda: FK.group_round_step(vals, w, gids, cs, cq, cm))
        want = ref.group_round_step(vals, w, gids, cs, cq, cm)
        err = compare(f"K1 group {label}", got, want, {2})
        checks["fused_round_step/group"] = max(checks.get("fused_round_step/group", 0.0), err)
        group_inputs[label] = (gla, vals, w, gids, cs, cq, cm)
        say("check", kernel=f"fused_round_step/group[{label}]",
            shape=tuple(vals.shape), max_abs_err=err, repeat="bitwise-equal")
    # Q15's round-slice at SF 100 (tpch-sf100 in olabench: C = 2,289 chunks a
    # round-slice, 1,000,000 suppliers, about 96% of the rows outside the
    # quarter with w = 0): the fold's windows of 32*s ids, s = 32
    G = Q15_SUPPLIERS
    vals = torch.rand((P, Q15_CHUNKS, L, 1), generator=g, device=dev) * 1e4
    w = (torch.rand((P, Q15_CHUNKS, L), generator=g, device=dev) < 0.04).float()
    gids = torch.randint(0, G, (P, Q15_CHUNKS, L), generator=g, device=dev,
                         dtype=torch.int32)
    cs = torch.rand((P, G, 1), generator=g, device=dev) * 1e6
    cq = torch.rand((P, G, 1), generator=g, device=dev) * 1e9
    cm = torch.randint(0, 500, (P, G), generator=g, device=dev).float()
    got = twice(lambda: FK.group_round_step(vals, w, gids, cs, cq, cm))
    err = compare("K1 group Q15", got, ref.group_round_step(vals, w, gids, cs, cq, cm), {2})
    checks["fused_round_step/group"] = max(checks["fused_round_step/group"], err)
    group_inputs["Q15"] = (None, vals, w, gids, cs, cq, cm)
    say("check", kernel="fused_round_step/group[Q15]", shape=tuple(vals.shape),
        groups=G, span=ops.group_step_span(L, 1, G), max_abs_err=err,
        repeat="bitwise-equal")
    del got

    valsK2, wK2, _ = FK.project(q6.fused, shards)  # K2 runs on the whole shard
    got = twice(lambda: FK.scalar_prefix(valsK2, wK2))[0]
    want = ref.scalar_prefix(valsK2, wK2)
    checks["fused_prefix_states"] = compare(
        "K2", (got[..., :2], got[..., 2]), (want[..., :2], want[..., 2]), {1})
    say("check", kernel="fused_prefix_states", shape=tuple(valsK2.shape),
        max_abs_err=checks["fused_prefix_states"], repeat="bitwise-equal")
    del want, got

    # K4 on the whole shard, as run_query(Q6 without its fused contract)
    vK4, wK4 = (x.to(torch.float32).contiguous() for x in q6.kernel_cols(shards))
    mK4 = shards["_mask"]
    got = twice(lambda: ops.shard_chunk_partials(vK4, wK4, mK4))[0]
    want = ref.shard_chunk_partials(vK4, wK4, mK4)
    checks["shard_chunk_partials"] = compare(
        "K4", (got[..., :2], got[..., 2:]), (want[..., :2], want[..., 2:]), {1})
    say("check", kernel="shard_chunk_partials", shape=tuple(vK4.shape),
        max_abs_err=checks["shard_chunk_partials"], repeat="bitwise-equal")
    del want, got

    # K3 on one round-slice: Q3 alone (A=1, G=5), and the [Q6, Q1-small, Q3]
    # bundle of the legacy path in one pf_group_agg_bundle launch, each
    # member at its own shape and bitwise-equal to its own launch
    b3 = T.GLABundle([q6, q1s, q3])
    k3_inputs = {"Q3": scan.kernel_operands(q3, sl),
                 "stack": [scan.kernel_operands(m, sl) for m in b3.members]}
    v, w, gi, G = k3_inputs["Q3"]
    got = twice(lambda: ops.group_agg(v, w, gi, num_groups=G, block_rows=L))
    want = ref.group_agg(v, w, gi, G, L)
    checks["group_agg"] = compare("K3 Q3", got, want, {2})
    say("check", kernel="group_agg[Q3]", shape=tuple(v.shape), groups=G,
        max_abs_err=checks["group_agg"], repeat="bitwise-equal")
    del want, got

    def check_k3_bundle(name, members):
        """A K3 bundle against its plain version: repeats bitwise-equal,
        every member bitwise-equal to its own launch; the largest error."""
        got = ops.group_agg_bundle(members, block_rows=L)
        again = ops.group_agg_bundle(members, block_rows=L)
        torch.cuda.synchronize()
        err = 0.0
        for i, ((v, w, gi, G), a, b) in enumerate(zip(members, got, again)):
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"{name}: member {i}'s repeat run is not bitwise-equal")
            solo = ops.group_agg(v, w, gi, num_groups=G, block_rows=L)
            check(all(torch.equal(x, y) for x, y in zip(a, solo)),
                  f"{name}: member {i} differs from its own launch")
            err = max(err, compare(f"{name} member {i}", a, ref.group_agg(v, w, gi, G, L),
                                   {2}))
        return err

    stack = k3_inputs["stack"]
    err = check_k3_bundle("K3 bundle", stack)
    checks["group_agg"] = max(checks["group_agg"], err)
    say("check", kernel="group_agg[stack]", members=[tuple(m[0].shape) for m in stack],
        groups=[m[3] for m in stack], max_abs_err=err,
        members_vs_solo="bitwise-equal", repeat="bitwise-equal")
    # olabench's sf100-report-join bundle [Q6, Q1, Q15, Q10, Q14] at its
    # round-slice: five members at their own (A, G) in one launch, Q15's
    # and Q10's folds in windows of 32*s ids, s > 1
    jb = join_bundle(dev, Q15_CHUNKS, SEED + 35)
    err = check_k3_bundle("K3 report-join bundle", jb)
    checks["group_agg"] = max(checks["group_agg"], err)
    say("check", kernel="group_agg_bundle[report-join-sf100]", shape=tuple(jb[1][0].shape),
        groups=[m[3] for m in jb], span=[ops.group_step_span(L, m[0].shape[-1], m[3])
                                         for m in jb],
        max_abs_err=err, members_vs_solo="bitwise-equal", repeat="bitwise-equal")
    del jb

    # K1 bundle on one round-slice: [Q6, Q1-small, Q1-large, supplier ⋈
    # nation], every member bitwise-equal to its solo K1 launch
    bf = T.GLABundle([q6, q1s, q1l, jn])
    bundle_args = []
    for gla in bf.members:
        vals, w, gids = FK.project(gla.fused, sl)
        A = vals.shape[-1]
        if gids is None:
            bundle_args.append((vals, w, None, carry))
        else:
            G = gla.fused.num_groups
            bundle_args.append((
                vals, w, gids, torch.rand((P, G, A), generator=g, device=dev) * 1e3,
                torch.rand((P, G, A), generator=g, device=dev) * 1e6,
                torch.randint(0, 1000, (P, G), generator=g, device=dev).float()))

    def check_bundle(name, margs):
        """K1 bundle against its plain version: repeats bitwise-equal, every
        member bitwise-equal to its solo K1 launch; the largest error."""
        got = FK.bundle_round_step(margs)
        again = FK.bundle_round_step(margs)
        want = ref.bundle_round_step(margs)
        torch.cuda.synchronize()
        err = 0.0
        for i, (m, a, b, r) in enumerate(zip(margs, got, again, want)):
            if m[2] is None:
                solo = FK.scalar_round_step(m[0], m[1], m[3])
                A = m[0].shape[-1]
                a, b, r, solo = ((t[:, :2 * A], t[:, 2 * A]) for t in (a, b, r, solo))
                exact = {1}
            else:
                solo, exact = FK.group_round_step(*m), {2}
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"{name} member {i}: repeat run is not bitwise-equal")
            check(all(torch.equal(x, y) for x, y in zip(a, solo)),
                  f"{name} member {i}: differs from its solo launch")
            err = max(err, compare(f"{name} member {i}", a, r, exact))
        return err

    checks["fused_round_step/bundle"] = check_bundle("K1 bundle", bundle_args)
    say("check", kernel="fused_round_step/bundle", members=len(bundle_args),
        max_abs_err=checks["fused_round_step/bundle"], repeat="bitwise-equal",
        members_vs_solo="bitwise-equal")
    # olabench's report bundle [Q6, Q1 by returnflag x linestatus, Q15] at
    # both cells' round-slices: Q1 at s = 1 beside Q15 at s > 1 in one fold
    # launch
    for label, (chunks, suppliers) in REPORT_SLICES.items():
        margs = report_bundle(dev, chunks, suppliers, SEED + 15)
        err = check_bundle(f"K1 report bundle {label}", margs)
        checks["fused_round_step/bundle"] = max(checks["fused_round_step/bundle"], err)
        say("check", kernel=f"fused_round_step/bundle[report-{label}]",
            shape=tuple(margs[0][0].shape), groups=[4, suppliers],
            span=[ops.group_step_span(L, 4, 4), ops.group_step_span(L, 1, suppliers)],
            max_abs_err=err, repeat="bitwise-equal", members_vs_solo="bitwise-equal")
        del margs

    # K1's decode stage on the encoded source's first round-slice: every
    # encoded column in one launch, bitwise its plain version and the plain
    # column itself (the decode is exact)
    phys = {k: torch.from_numpy(v).to(dev) for k, v in enc_src.slice_cols(0, per).items()}
    dec_in = [(phys[k], e) for k, e in enc_src.encodings]

    def plain_decode():
        return [ref.decode_dict(x, e.table(dev)) if isinstance(e, ENC.DictEncoding)
                else ref.decode_bitpacked(x, e.bits) for x, e in dec_in]

    got, again, want = KD.decode(dec_in), KD.decode(dec_in), plain_decode()
    torch.cuda.synchronize()
    for (k, _), a, b, r in zip(enc_src.encodings, got, again, want):
        check(torch.equal(a, b), f"decode {k}: repeat run is not bitwise-equal")
        check(a.dtype == r.dtype and torch.equal(a, r),
              f"decode {k}: differs from its plain version")
        check(torch.equal(a, sl[k]), f"decode {k}: differs from the plain column")
    checks["decode"] = 0.0
    say("check", kernel="decode", columns=[k for k, _ in enc_src.encodings],
        shape=tuple(phys["_mask"].shape), vs_plain="bitwise-equal",
        vs_column="bitwise-equal", repeat="bitwise-equal")
    del got, again, want

    # K5 and K6 on the first round-slice flattened (14,680,064 rows: every
    # count below 2**24, so counters are exact integers in f32), and K6 on
    # the whole shard against the float64 Q6 oracle
    flat_sl = {k: v.reshape(-1) for k, v in sl.items()}
    v5, w5 = q6.fused.func(flat_sl), q6.fused.cond(flat_sl)
    got = twice(lambda: ops.chunk_agg(v5, w5, flat_sl["_mask"]))[0]
    want = ref.chunk_agg(v5, w5, flat_sl["_mask"])
    checks["chunk_agg"] = compare("K5", (got[:2], got[2:]), (want[:2], want[2:]), {1})
    say("check", kernel="chunk_agg", rows=v5.numel(),
        max_abs_err=checks["chunk_agg"], repeat="bitwise-equal")
    lo6, hi6 = tpch.Q6_LOW_WINDOW
    q6_params = torch.tensor([lo6, hi6, 0.02 - 1e-6, 0.03 + 1e-6, 1.0], device=dev)

    def q6_cols(c):
        return (c["shipdate"], c["discount"], c["quantity"], c["extendedprice"], c["_mask"])

    got6 = twice(lambda: ops.q6_agg(q6_params, *q6_cols(flat_sl)))[0]
    want = ref.q6_agg(q6_params, *q6_cols(flat_sl))
    checks["q6_agg"] = compare("K6", (got6[:2], got6[2:]), (want[:2], want[2:]), {1})
    check(torch.equal(got6, got), "K6 differs from K5 over Q6's closures")
    exact6 = tpch.exact_answer(flat, q6.fused.func, q6.fused.cond)[0]
    count6 = tpch.exact_answer(flat, lambda c: torch.ones_like(c["discount"]),
                               q6.fused.cond)[0]
    full6 = twice(lambda: ops.q6_agg(q6_params, *q6_cols(flat)))[0].double()
    for i, want_ in ((0, exact6), (3, count6), (2, float(ROWS))):
        err_ = abs(float(full6[i]) - float(want_)) / abs(float(want_))
        check(err_ <= ORACLE_RTOL, f"K6 output {i} off the oracle by {err_:.3e}")
    say("check", kernel="q6_agg", rows=v5.numel(), max_abs_err=checks["q6_agg"],
        repeat="bitwise-equal", vs_k5_on_closures="bitwise-equal",
        full_rows=ROWS, full_sum=float(full6[0]), oracle_sum=float(exact6),
        full_matched=float(full6[3]), oracle_matched=float(count6))
    del got, want, v5, w5, flat_sl

    # -- 3./4. the main path, through the public entry points ----------------
    # Each path is run with the launch counts set to 0 just before it and is
    # held to its own expected counts just after; `launches` sums the paths.
    e2e = {}
    launches = dict.fromkeys(FK.LAUNCHES, 0)

    def path_launches(name, expected):
        """The counts of the path just run; every kernel not in
        ``expected`` must have launched no time."""
        got = FK.launch_counts()
        want = {k: expected.get(k, 0) for k in got}
        check(got == want, f"{name}: launches {got}, expected {want}")
        for k, n in got.items():
            launches[k] += n
        return got

    def exact_of(fs, **kw):
        return tpch.exact_answer(flat, fs.func, fs.cond, **kw)

    FK.reset_launch_counts()
    t0 = time.perf_counter()
    res = twin_rq6 = T.run_query(T.QuerySpec(q6, rounds=ROUNDS, emit="kernel"), shards,
                                 device=dev)
    final = float(res.final)
    e2e["run_query q6"] = time.perf_counter() - t0
    got = path_launches("run_query q6", {"fused_prefix_states": 1})
    rel6 = abs(final - float(exact6)) / abs(float(exact6))
    check(rel6 < ORACLE_RTOL, f"Q6 final {final} vs exact {float(exact6)}")
    est = res.estimates
    check(torch.isfinite(est.estimate).all().item(), "Q6 estimates not finite")
    say("run_query", query="q6-low", emit="kernel", final=final,
        exact=float(exact6), rel_err=f"{rel6:.3e}",
        last_estimate=float(est.estimate[-1]),
        seconds=f"{e2e['run_query q6']:.3f}", launches=got)

    def session(name, gla, stop, exact, kernel):
        """A session to its stopping rule; its last estimate must sit
        within 3 half-widths (about 6 standard errors) of the truth."""
        FK.reset_launch_counts()
        t0 = time.perf_counter()
        sess = T.Session(T.QuerySpec(gla, rounds=ROUNDS, emit="kernel", stop=stop),
                         shards, device=dev)
        r = sess.run()
        torch.cuda.synchronize()
        e2e[f"session {name}"] = time.perf_counter() - t0
        got = path_launches(f"session {name}", {kernel: sess.steps_taken})
        e = r.estimates
        last = e.estimate[-1].double()
        lo, hi = e.lower[-1].double(), e.upper[-1].double()
        check(torch.isfinite(last).all().item(), f"{name}: estimate not finite")
        check(bool((lo <= last).all() and (last <= hi).all()), f"{name}: bounds")
        ex = exact.to(last.device).reshape(last.shape)
        check(bool(((last - ex).abs()
                    <= 3 * (hi - lo) / 2 + ORACLE_RTOL * ex.abs()).all()),
              f"{name}: estimate far from the exact answer")
        say("session", query=name, stop="rel_width(0.01)",
            steps_taken=sess.steps_taken, rounds_total=sess.rounds_total,
            converged=sess.converged,
            last_estimate=[round(x, 4) for x in last.reshape(-1)[:8].tolist()],
            half_width=[round(x, 4) for x in ((hi - lo) / 2).reshape(-1)[:8].tolist()],
            seconds=f"{e2e[f'session {name}']:.3f}", launches=got)

    def full_scan(name, gla, exact):
        """A session over all 16 rounds (the engine's group path: one K1
        launch per round-slice); its final within ORACLE_RTOL of the truth."""
        FK.reset_launch_counts()
        t0 = time.perf_counter()
        sess = T.Session(T.QuerySpec(gla, rounds=ROUNDS, emit="kernel"), shards,
                         device=dev)
        r = sess.run()
        torch.cuda.synchronize()
        e2e[f"session {name}"] = time.perf_counter() - t0
        got = path_launches(f"session {name}", {"fused_round_step/group": ROUNDS})
        check(sess.steps_taken == ROUNDS, f"{name}: {sess.steps_taken} rounds")
        fin = r.final.double()
        check(fin.shape == exact.shape, f"{name}: final shape")
        check(torch.isfinite(r.estimates.estimate).all().item(), f"{name}: estimates")
        relerr = ((fin - exact).abs() / exact.abs().clamp(min=1e-300)).max().item()
        check(bool(((fin - exact).abs() <= ORACLE_RTOL * exact.abs()).all()),
              f"{name}: final off the exact answer (max rel {relerr:.3e})")
        say("session", query=name, stop=None, steps_taken=sess.steps_taken,
            final_max_rel_err=f"{relerr:.3e}",
            matched=int(r.snapshots.matched[-1].sum().item()),
            seconds=f"{e2e[f'session {name}']:.3f}", launches=got)

    exact1s = exact_of(q1s.fused, group=q1s.fused.group, num_groups=4)
    session("q6-low", q6, T.rel_width(0.01), exact6, "fused_round_step/scalar")
    session("q1-small", q1s, T.rel_width(0.01), exact1s, "fused_round_step/group")
    full_scan("q1-small(4 groups)", q1s, exact1s)
    exact1l = exact_of(q1l.fused, group=q1l.fused.group,
                       num_groups=q1l.fused.num_groups)
    full_scan("q1-large(2^13 buckets)", q1l, exact1l)

    def oracle_run(name, fn, expected, exacts):
        """One run of a query or bundle through its entry point, held to
        its launch counts and each final to the float64 oracle."""
        FK.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        e2e[name] = time.perf_counter() - t0
        got = path_launches(name, expected)
        res = res if isinstance(res, list) else [res]
        errs = []
        for r, exact in zip(res, exacts):
            fin = r.final.double().reshape(exact.shape)
            check(torch.isfinite(r.estimates.estimate).all().item(),
                  f"{name}: estimates not finite")
            err = ((fin - exact).abs() / exact.abs().clamp(min=1e-300)).max().item()
            check(bool(((fin - exact).abs() <= ORACLE_RTOL * exact.abs()).all()),
                  f"{name}: final off the exact answer (max rel {err:.3e})")
            errs.append(f"{err:.3e}")
        say("run", path=name, final_max_rel_err=errs,
            seconds=f"{e2e[name]:.3f}", launches=got)

    exact3 = tpch.exact_answer(flat, tpch.q6_func, tpch.q1_cond,
                               num_groups=tpch.NUM_SEGMENTS, join_key=tpch.orderkey,
                               dim_group=orders[0], dim_valid=orders[1])
    exactn = tpch.exact_answer(flat, tpch.q1_func, tpch.q1_cond,
                               num_groups=tpch.NUM_NATIONS,
                               join_key=tpch.q1_group_large,
                               dim_group=nation[0], dim_valid=nation[1])
    spec = lambda g: T.QuerySpec(g, rounds=ROUNDS, emit="kernel")  # noqa: E731
    oracle_run("run_query q3 (K3)", lambda: T.run_query(spec(q3), shards, device=dev),
               {"group_agg": ROUNDS}, [exact3])
    session("q3", q3, T.rel_width(0.01), exact3, "group_agg")
    oracle_run("run_queries [q6, q1-small, q3] (K3)",
               lambda: T.run_queries(spec([q6, q1s, q3]), shards, device=dev),
               {"group_agg": ROUNDS}, [exact6, exact1s, exact3])
    oracle_run("run_queries [q6, q1-small, q1-large, nation] (K1 bundle)",
               lambda: T.run_queries(spec([q6, q1s, q1l, jn]), shards, device=dev),
               {"fused_round_step/bundle": ROUNDS},
               [exact6, exact1s, exact1l, exactn])
    oracle_run("run_query nation (K1 group)",
               lambda: T.run_query(spec(jn), shards, device=dev),
               {"fused_round_step/group": ROUNDS}, [exactn])
    oracle_run("run_query q6, no fused contract (K4)",
               lambda: T.run_query(spec(q6k), shards, device=dev),
               {"shard_chunk_partials": 1}, [exact6])
    session("q6-low, no fused contract", q6k, T.rel_width(0.01), exact6,
            "shard_chunk_partials")

    # the out-of-core scan: each session stepped over the resident shards
    # (its twin), then streamed from the npy and from the encoded copy —
    # every final, snapshot and per-round estimate bitwise the twin's
    def leaves(tree):
        out = []
        tree_map(out.append, tree)
        return out

    def same(a, b):
        la, lb = leaves(a), leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))

    streamed = (("q6", q6, "fused_round_step/scalar"),
                ("q1-small", q1s, "fused_round_step/group"),
                ("[q6, q1-small]", T.GLABundle([q6, q1s]), "fused_round_step/bundle"))
    twins = {}
    for qname, gla, kernel in streamed:
        FK.reset_launch_counts()
        t0 = time.perf_counter()
        sess = T.Session(spec(gla), shards, device=dev)
        while not sess.done:
            sess.step()
        twins[qname] = sess.result()
        torch.cuda.synchronize()
        e2e[f"resident {qname}"] = time.perf_counter() - t0
        got = path_launches(f"resident {qname}", {kernel: ROUNDS})
        say("resident", query=qname, steps=sess.steps_taken,
            seconds=f"{e2e[f'resident {qname}']:.3f}", launches=got)
    slice_bytes = ROWS // ROUNDS * 28  # one logical round-slice of STREAM_COLS
    exact6_src = tpch.exact_answer(enc_src, q6.fused.func, q6.fused.cond, device=dev)[0]
    check(abs(float(exact6_src) - float(exact6)) <= 1e-9 * abs(float(exact6)),
          "the oracle over the encoded source differs from the flat one")
    for sname, src in (("npy", npy_src), ("encoded", enc_src)):
        for qname, gla, kernel in streamed:
            name = f"streamed {sname} {qname}"
            FK.reset_launch_counts()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sess = T.Session(spec(gla), src, device=dev)
            res = sess.run()
            torch.cuda.synchronize()
            e2e[name] = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            want = {kernel: ROUNDS, "decode": ROUNDS if src.encodings else 0}
            got = path_launches(name, want)
            twin = twins[qname]
            check(sess.steps_taken == ROUNDS, f"{name}: {sess.steps_taken} rounds")
            check(same(res.final, twin.final), f"{name}: final differs from resident")
            check(same(res.snapshots, twin.snapshots),
                  f"{name}: snapshots differ from resident")
            check(same(res.estimates, twin.estimates),
                  f"{name}: per-round estimates differ from resident")
            check(peak <= STREAM_PEAK_SLICES * slice_bytes,
                  f"{name}: peak device memory {peak} B is not O(slice)")
            q6_final = res.final if qname == "q6" else (
                res.final[0] if qname.startswith("[") else None)
            if q6_final is not None:
                err_ = abs(float(q6_final) - float(exact6_src)) / abs(float(exact6_src))
                check(err_ < ORACLE_RTOL, f"{name}: Q6 final off the oracle by {err_:.3e}")
            io = sess.io_stats
            check(io["slices"] == ROUNDS, f"{name}: {io['slices']} slices copied")
            say("stream", source=sname, query=qname, bitwise_vs_resident=True,
                seconds=f"{e2e[name]:.3f}",
                resident_seconds=f"{e2e[f'resident {qname}']:.3f}",
                h2d_bytes_per_round=io["bytes"] // ROUNDS,
                host_read_s=io["read_s"], h2d_copy_ms=io["copy_ms"], waited_s=io["wait_s"],
                peak_device_bytes=peak, peak_in_slices=f"{peak / slice_bytes:.3f}",
                launches=got)
    # -- 4b. failures, stragglers, pause/resume and elastic resume ----------
    # Every phase runs at full width through the public entry points, held
    # to its launch counts; the uninterrupted runs are the resident twins
    # above where one exists.
    from repro_torch import fault as FT

    def members(est):
        return (est,) if isinstance(est, T.Estimate) else tuple(
            e for e in est if e is not None)

    def no_nan(name, res):
        check(not any(torch.isnan(x).any().item()
                      for x in leaves((res.final, res.snapshots, res.estimates))),
              f"{name}: NaN in the result")

    def first_rounds_equal(a, b, n):
        la, lb = leaves(a), leaves(b)
        return len(la) == len(lb) and all(torch.equal(x[:n], y[:n]) for x, y in zip(la, lb))

    def without(p):
        """The float64 oracle over every partition but p: the whole table's
        answer minus partition p's (its rows are a view of the shards)."""
        part = {k: v[p].reshape(-1) for k, v in shards.items()}
        return lambda fs, **kw: exact_of(fs, **kw) - tpch.exact_answer(
            part, fs.func, fs.cond, **kw)

    def final_errs(name, res, exacts):
        finals = res.final if isinstance(res.final, tuple) else (res.final,)
        errs = []
        for fin, ex in zip(finals, exacts, strict=True):
            fin = fin.double().reshape(ex.shape)
            err = ((fin - ex).abs() / ex.abs().clamp(min=1e-300)).max().item()
            check(bool(((fin - ex).abs() <= ORACLE_RTOL * ex.abs()).all()),
                  f"{name}: final off the oracle (max rel {err:.3e})")
            errs.append(f"{err:.3e}")
        return errs

    # [fault]: partition 2 lost at round 5 of 16 (FaultPolicy.fail_at)
    surv = without(FAIL_P)
    ex6_s = surv(q6.fused)[0]
    ex1s_s = surv(q1s.fused, group=q1s.fused.group, num_groups=4)
    q1s_sync = q6_q1s(d, "synchronized")[1]
    q6m = T.make_sum_gla(tpch.q6_func, tpch.q6_cond(tpch.Q6_LOW_WINDOW), d_total=d,
                         estimator="multiple")
    faulted = {}
    for qname, gla, emit, family, kernel, exacts in (
            ("q6", q6, "kernel", "single", "fused_round_step/scalar", (ex6_s,)),
            ("q1-small", q1s, "kernel", "single", "fused_round_step/group", (ex1s_s,)),
            ("q1-small", q1s_sync, "kernel", "synchronized", "fused_round_step/group",
             (ex1s_s,)),
            ("[q6, q1-small]", T.GLABundle([q6, q1s]), "kernel", "single",
             "fused_round_step/bundle", (ex6_s, ex1s_s)),
            ("q6", q6m, "round", "multiple", None, (ex6_s,))):
        name = f"fault {qname} {family}"
        qs = T.QuerySpec(gla, rounds=ROUNDS, emit=emit)
        expected = {kernel: ROUNDS} if kernel else {}
        base = twins[qname] if family == "single" else None
        t_base = None
        if base is None:
            FK.reset_launch_counts()
            t0 = time.perf_counter()
            base = drive(T.Session(qs, shards, device=dev))
            torch.cuda.synchronize()
            t_base = time.perf_counter() - t0
            path_launches(f"{name}: uninterrupted", expected)
        FK.reset_launch_counts()
        t0 = time.perf_counter()
        sess = T.Session(qs.with_(fault=T.FaultPolicy(family, fail_at={FAIL_P: FAIL_R})),
                         shards, device=dev)
        res = drive(sess)
        torch.cuda.synchronize()
        e2e[name] = time.perf_counter() - t0
        got = path_launches(name, expected)
        faulted[qname, family] = res
        no_nan(name, res)
        check(first_rounds_equal(res.estimates, base.estimates, FAIL_R)
              and first_rounds_equal(res.snapshots, base.snapshots, FAIL_R),
              f"{name}: rounds before the failure differ from the uninterrupted run")
        widths = []
        for e, eb in zip(members(res.estimates), members(base.estimates), strict=True):
            after = slice(FAIL_R, None)
            if family == "single":
                check(bool(torch.isfinite(e.lower).all() and torch.isfinite(e.upper).all()),
                      f"{name}: a bound is not finite")
                w, wb = (e.upper - e.lower)[-1].max().item(), (eb.upper - eb.lower)[-1].max().item()
                check(w > wb, f"{name}: last round {w} not wider than uninterrupted {wb}")
                widths.append(f"{w:.6g} > {wb:.6g}")
            elif family == "synchronized":
                check(all(torch.equal(x[after], x[FAIL_R - 1].expand_as(x[after]))
                          for x in (e.estimate, e.lower, e.upper)),
                      f"{name}: rounds {FAIL_R}-{ROUNDS - 1} not frozen at round {FAIL_R - 1}")
            else:
                check(bool(torch.isneginf(e.lower[after]).all()
                           and torch.isposinf(e.upper[after]).all()),
                      f"{name}: bounds not (-inf, +inf) from round {FAIL_R}")
        say("fault", query=qname, estimator=family, emit=emit,
            fail_at={FAIL_P: FAIL_R}, first_rounds_vs_uninterrupted="bitwise",
            last_width_vs_uninterrupted=widths or None,
            final_vs_survivors_max_rel_err=final_errs(name, res, exacts),
            seconds=f"{e2e[name]:.3f}",
            uninterrupted_seconds=None if t_base is None else f"{t_base:.3f}",
            launches=got)

    # [fault-stream]: the npy copy dies under partition 2 inside round 5
    c_fail = FAIL_R * per + per // 2
    for qname, gla, kernel in streamed[:2]:
        name = f"fault-stream {qname}"
        FK.reset_launch_counts()
        t0 = time.perf_counter()
        sess = T.Session(spec(gla).with_(fault=T.FaultPolicy("single")),
                         FT.FailingSource(npy_src, {FAIL_P: c_fail}), device=dev)
        res = drive(sess)
        torch.cuda.synchronize()
        e2e[name] = time.perf_counter() - t0
        got = path_launches(name, {kernel: ROUNDS})
        check(sess._fail_at == {FAIL_P: FAIL_R},
              f"{name}: failure recorded as {sess._fail_at}, not {{{FAIL_P}: {FAIL_R}}}")
        inj = faulted[qname, "single"]
        check(same(res.final, inj.final) and same(res.snapshots, inj.snapshots)
              and same(res.estimates, inj.estimates),
              f"{name}: differs from the resident session with fail_at")
        say("fault-stream", query=qname, fail_chunk={FAIL_P: c_fail},
            recorded_fail_at=sess._fail_at, bitwise_vs_resident_fail_at=True,
            seconds=f"{e2e[name]:.3f}", slices_read=sess.io_stats["slices"],
            launches=got)
    FK.reset_launch_counts()
    sess = T.Session(spec(q6), FT.FailingSource(npy_src, {FAIL_P: c_fail}), device=dev)
    lost = None
    try:
        drive(sess)
    except FT.PartitionLostError as err:
        lost = str(err)
    check(lost is not None and f"[{FAIL_P}]" in lost,
          f"fault-stream without a policy: no PartitionLostError naming [{FAIL_P}]")
    got = path_launches("fault-stream q6, no policy", {"fused_round_step/scalar": FAIL_R})
    say("fault-stream", query="q6", policy=None, raised=repr(lost),
        rounds_run=sess.steps_taken, launches=got)

    # [pause]: Q1-large paused after 5 rounds, resumed here and in a fresh
    # process (which makes the same data again from SEED and reuses the
    # kernels built under build/)
    ck = work / "q1-large.ckpt"
    FK.reset_launch_counts()
    base = drive(T.Session(spec(q1l), shards, device=dev))
    path_launches("pause: q1-large uninterrupted", {"fused_round_step/group": ROUNDS})
    FK.reset_launch_counts()
    sess = T.Session(spec(q1l), shards, device=dev)
    for _ in range(5):
        sess.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.pause(ck)
    t_pause = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = T.Session.resume(ck, q1l, shards, device=dev)
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    res = drive(back)
    torch.cuda.synchronize()
    got = path_launches("pause q1-large", {"fused_round_step/group": ROUNDS})
    check(back.steps_taken == ROUNDS and same(res.final, base.final)
          and same(res.snapshots, base.snapshots) and same(res.estimates, base.estimates),
          "pause: the resumed run differs from the uninterrupted one")
    del sess, back, res
    torch.cuda.empty_cache()  # room for the child's copy of the data
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), RESUME_CHILD,
                            str(ck)], capture_output=True, text=True, timeout=600)
    t_child = time.perf_counter() - t0
    check(child.returncode == 0, f"pause: the resume process failed:\n{child.stderr[-3000:]}")
    out = json.loads(child.stdout.strip().splitlines()[-1])
    check(out["resumed_at"] == 5 and out["steps"] == ROUNDS
          and out["digest"] == digest((base.final, base.estimates)),
          f"pause: the fresh process's run differs from the uninterrupted one: {out}")
    say("pause", query="q1-large(2^13 buckets)", emit="kernel", paused_after=5,
        checkpoint_bytes=ck.stat().st_size, pause_s=f"{t_pause:.3f}",
        resume_s=f"{t_resume:.3f}", in_process="bitwise", fresh_process="bitwise",
        fresh_process_s=f"{t_child:.3f}", fresh_data_s=f"{out['data_s']:.3f}",
        fresh_resume_s=f"{out['resume_s']:.3f}", fresh_run_s=f"{out['run_s']:.3f}",
        launches=got)

    # [elastic]: Q6 and Q1-small paused at round 4 on P=8, resumed on 4 and
    # on 16 partitions and taken 8 -> 4 -> 8; each view's round-slices are
    # gathered on the card from the resident table
    slice_all = sum(v.numel() * v.element_size() for v in shards.values()) // ROUNDS
    at = DIST_AT
    elastic_res = {}  # (query, chain) -> result, the [dist-elastic] twins
    for qname, gla, kernel in streamed[:2]:
        twin = twins[qname]
        FK.reset_launch_counts()
        sess = T.Session(spec(gla), shards, device=dev)
        for _ in range(at):
            sess.step()
        ck = work / f"elastic-{qname}.ckpt"  # the [dist-elastic] twin
        sess.pause(ck)
        path_launches(f"elastic {qname}: first {at} rounds", {kernel: at})
        for chain in ((4,), (16,), (4, 8)):
            name = f"elastic {qname} 8->" + "->".join(map(str, chain))
            FK.reset_launch_counts()
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            path_ = ck
            for j, pn in enumerate(chain):
                back = T.Session.resume(path_, gla, shards, partitions=pn, device=dev)
                carry_r, r0 = back._states, back.steps_taken
                if j + 1 < len(chain):
                    back.step()
                    back.step()
                    path_ = work / f"elastic-{j}.ckpt"
                    back.pause(path_)
            res = elastic_res[qname, chain] = drive(back)
            torch.cuda.synchronize()
            e2e[name] = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - mem0
            got = path_launches(name, {kernel: ROUNDS - at})
            ref_final = twin.final
            tol = SUM_RTOL * ref_final.abs().max().item()
            check(torch.allclose(res.final, ref_final, rtol=SUM_RTOL, atol=tol),
                  f"{name}: final off the uninterrupted run by more than SUM_RTOL")
            check(torch.equal(res.snapshots.scanned, twin.snapshots.scanned)
                  and torch.equal(res.snapshots.matched, twin.snapshots.matched),
                  f"{name}: scanned/matched differ from the uninterrupted run")
            check(peak <= 2 * slice_all,
                  f"{name}: peak device memory {peak} B above the resident table "
                  f"exceeds two round-slices ({2 * slice_all} B)")
            # K1 at the new partition count against its plain version, on the
            # round-slice it ran first, from the carry the resume made
            view = T.repartition(shards, chain[-1])
            per_new = view.spec.C // ROUNDS
            sl_new = view.slice_cols(r0 * per_new, (r0 + 1) * per_new)
            vals_n, w_n, gids_n = FK.project(gla.fused, sl_new)
            if gids_n is None:
                cin = torch.cat([carry_r.sum, carry_r.sumsq, carry_r.matched[:, None]], 1).contiguous()
                k, r_ = FK.scalar_round_step(vals_n, w_n, cin), ref.scalar_round_step(vals_n, w_n, cin)
                err = compare(f"{name}: K1 scalar", (k[:, :2], k[:, 2]), (r_[:, :2], r_[:, 2]), {1})
                kname = "fused_round_step/scalar"
            else:
                cin = (carry_r.sum.contiguous(), carry_r.sumsq.contiguous(),
                       carry_r.matched.contiguous())
                err = compare(f"{name}: K1 group", FK.group_round_step(vals_n, w_n, gids_n, *cin),
                              ref.group_round_step(vals_n, w_n, gids_n, *cin), {2})
                kname = "fused_round_step/group"
            checks[kname] = max(checks[kname], err)
            zero_children = int((carry_r.matched.reshape(chain[-1], -1) == 0).all(dim=1).sum())
            del sl_new, vals_n, w_n, gids_n
            say("elastic", query=qname, chain="8->" + "->".join(map(str, chain)),
                paused_at=at, final_rel_err_vs_uninterrupted=(
                    (res.final.double() - ref_final.double()).abs().max().item()
                    / ref_final.double().abs().max().item()),
                counters_vs_uninterrupted="exact", peak_device_bytes=peak,
                peak_in_slices=f"{peak / slice_all:.3f}",
                k1_vs_plain=dict(kernel=kname, shape=tuple(carry_r.sum.shape),
                                 zero_carries=zero_children, max_abs_err=err),
                seconds=f"{e2e[name]:.3f}", launches=got)

    # [straggler]: partition 7 at a quarter of the others' speed
    sched = T.straggler_schedule(P, C, ROUNDS, SPEEDS)
    q6sync = T.make_sum_gla(tpch.q6_func, tpch.q6_cond(tpch.Q6_LOW_WINDOW), d_total=d,
                            estimator="synchronized")
    ex6_3 = without(3)(q6.fused)[0]
    for name, fn, expected, exacts, scanned in (
            ("q6 single async, emit=kernel (K2)",
             lambda: T.run_query(T.QuerySpec(q6, schedule=sched, emit="kernel"), shards,
                                 device=dev),
             {"fused_prefix_states": 1}, (exact6,), L * sched[:, 1:].sum(axis=0)),
            ("q6 synchronized, sync=True, emit=chunk",
             lambda: T.run_query(T.QuerySpec(q6sync, schedule=sched, sync=True,
                                             emit="chunk"), shards, device=dev),
             {}, (exact6,), L * P * sched[:, 1:].min(axis=0)),
            ("q1-small, emit=round_masked",
             lambda: T.run_query(T.QuerySpec(q1s, schedule=sched, emit="round_masked"),
                                 shards, device=dev),
             {}, (exact1s,), L * sched[:, 1:].sum(axis=0)),
            ("run_with_failures q6, dead [3], emit=kernel (K2)",
             lambda: FT.run_with_failures(q6, shards, dead_partitions=[3], emit="kernel",
                                          device=dev),
             {"fused_prefix_states": 1}, (ex6_3,), None)):
        FK.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        e2e[f"straggler {name}"] = time.perf_counter() - t0
        got = path_launches(f"straggler {name}", expected)
        no_nan(name, res)
        for e in members(res.estimates):
            check(torch.isfinite(e.estimate).all().item(), f"{name}: estimates not finite")
        if scanned is not None:
            check(res.snapshots.scanned.cpu().numpy().tolist() == scanned.tolist(),
                  f"{name}: per-round scanned rows differ from the schedule's")
        say("straggler", path=name, speeds=SPEEDS, schedule_last_partition=sched[-1].tolist(),
            final_max_rel_err=final_errs(name, res, exacts),
            seconds=f"{e2e[f'straggler {name}']:.3f}", launches=got)
    FK.reset_launch_counts()
    t0 = time.perf_counter()
    floor = FT.variance_floor(q6, shards, [3], device=dev)
    got = path_launches("straggler variance_floor", {})
    check(floor > 0.0, f"variance floor {floor} is not above 0")
    say("straggler", path="variance_floor q6, dead [3], emit=chunk", floor=floor,
        seconds=f"{time.perf_counter() - t0:.3f}", launches=got)

    # -- 4c. partitions across processes --------------------------------
    # [dist-gloo]/[dist-fault]/[dist-elastic]: W=4 gloo ranks share the card
    # (NCCL refuses two ranks on one device), each over its 2 partitions of
    # the npy copy; [dist-nccl]: one NCCL rank over all 8, started with
    # them; then the W=4 pauses resumed on W=2 ranks.  Every result is held
    # to the one-process run of the same query above.
    small = {k: shards[k][:, :SYNC_C] for k in STREAM_COLS}
    sched_s = T.straggler_schedule(P, SYNC_C, ROUNDS, SPEEDS)
    t0 = time.perf_counter()
    sync_twin = T.run_query(T.QuerySpec(q6, schedule=sched_s, sync=True, emit="chunk"),
                            small, device=dev)
    torch.cuda.synchronize()
    e2e["sync q6 chunk (C/8)"] = time.perf_counter() - t0
    path_launches("sync q6 chunk (C/8)", {})
    del small
    torch.cuda.empty_cache()  # room for the ranks' blocks
    held = torch.cuda.memory_allocated()  # what this process holds meanwhile
    t0 = time.perf_counter()
    ranks = spawn_ranks({"gloo": DIST_WORLD, "nccl": 1}, work)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks.update(spawn_ranks({"resume": 2}, work))
    t_resume = time.perf_counter() - t0
    rank_launches = dict.fromkeys(FK.LAUNCHES, 0)

    def dist_phase(tag, job, name, want, expected, twin_s, exact=True, extra=None):
        """Every rank's ``name`` phase of ``job``: its result bitwise
        ``want`` (``exact=False``: finals within SUM_RTOL, counters exact),
        its launches exactly ``expected``; prints the phase's line."""
        got = [r["phases"][name] for r in ranks[job]]
        for k, g_ in enumerate(got):
            out = g_["out"][0] if type(g_["out"]) is tuple else g_["out"]  # (result, fail_at)
            if exact:
                check(same(out, want), f"[{tag}] {name}: rank {k} differs from one process")
            else:
                ref_final = want.final.cpu()
                check(torch.allclose(out.final, ref_final, rtol=SUM_RTOL,
                                     atol=SUM_RTOL * ref_final.abs().max().item()),
                      f"[{tag}] {name}: rank {k} final off by more than SUM_RTOL")
                check(torch.equal(out.snapshots.scanned, want.snapshots.scanned.cpu())
                      and torch.equal(out.snapshots.matched, want.snapshots.matched.cpu()),
                      f"[{tag}] {name}: rank {k} counters differ")
            check(g_["launches"] == expected,
                  f"[{tag}] {name}: rank {k} launched {g_['launches']}, expected {expected}")
            for kn, n in g_["launches"].items():
                rank_launches[kn] += n
        say(tag, run=name, ranks=len(got),
            vs_one_process="bitwise" if exact else "within SUM_RTOL, counters exact",
            seconds=[f"{g_['seconds']:.3f}" for g_ in got],
            one_process_seconds=None if twin_s is None else f"{twin_s:.3f}",
            collective_s_per_round=[f"{g_['collective_s_per_round']:.6f}" for g_ in got],
            gathered_bytes_per_round=[int(g_["gathered_bytes_per_round"]) for g_ in got],
            collectives=[g_["collectives"] for g_ in got],
            peak_device_bytes=[g_["peak_bytes"] for g_ in got],
            launches_per_rank=got[0]["launches"], **(extra or {}))
        return got

    scalar_k, group_k = {"fused_round_step/scalar": ROUNDS}, {"fused_round_step/group": ROUNDS}
    say("dist", ranks=DIST_WORLD, backend="gloo", device=str(dev), partitions_per_rank=P // DIST_WORLD,
        load_s=[f"{r['load_s']:.3f}" for r in ranks["gloo"]],
        spawn_to_end_s=f"{t_first:.3f}", resume_group_s=f"{t_resume:.3f}")
    for tag, job in (("dist-gloo", "gloo"), ("dist-nccl", "nccl")):
        dist_phase(tag, job, "run_query q6", _to_cpu(twin_rq6), {"fused_prefix_states": 1},
                   e2e["run_query q6"])
        for qname, _, kernel in (streamed if job == "gloo" else streamed[:2]):
            dist_phase(tag, job, f"session {qname}", _to_cpu(twins[qname]), {kernel: ROUNDS},
                       e2e[f"resident {qname}"])
    dist_phase("dist-gloo", "gloo", "streamed q6", _to_cpu(twins["q6"]), scalar_k,
               e2e["streamed npy q6"])
    audits = [r["audit"] for r in ranks["gloo"]]
    zero = dict.fromkeys(FK.LAUNCHES, 0)
    for k, a in enumerate(audits):
        check(a["launches"] == a["dispatches"] == zero and a["collectives_after"] == 0,
              f"[dist-gloo] audit: rank {k} left launches {a['launches']}, collectives "
              f"{a['collectives_after']}")
        audit_checked("dist-gloo", f"audit q6 rank {k}", a["report"],
                      ("one_collective_per_round", "fused_single_dispatch",
                       "o_slice_footprint", "dtype_discipline"),
                      seconds=f"{a['seconds']:.3f}",
                      collective_calls=a["report"].result(
                          "one_collective_per_round").data["calls"])
    calls = [a["report"].result("one_collective_per_round").data for a in audits]
    check(all(c == calls[0] for c in calls),
          f"[dist-gloo] audit: the ranks' collective calls differ: {calls}")
    for cost in (True, False):
        name = f"sync q6 chunk, sync_cost_model={cost}"
        outs = [r["phases"][name]["out"] for r in ranks["gloo"]]
        bitwise = all(same(o, _to_cpu(sync_twin)) for o in outs)
        dist_phase("dist-gloo", "gloo", name, _to_cpu(sync_twin), {},
                   e2e["sync q6 chunk (C/8)"], exact=bitwise,
                   extra={"chunks_per_partition": SYNC_C,
                          "chunk_coordinations": SYNC_C if cost else 0})
    # K1 on each rank's 2 partitions of round-slice 0 (zero carries): held
    # to its plain version, and bitwise the one-process launch's rows
    for qname, gla, kname in (("q6", q6, "fused_round_step/scalar"),
                              ("q1-small", q1s, "fused_round_step/group")):
        args = FK._member_args(gla.fused, scan.stack_init(gla, (P,), dev), sl)
        full = (FK.scalar_round_step(args[0], args[1], args[3]) if args[2] is None
                else FK.group_round_step(*args))
        full = (full[:, :2], full[:, 2]) if args[2] is None else full
        errs = []
        for k, r in enumerate(ranks["gloo"]):
            lo_, hi_ = k * P // DIST_WORLD, (k + 1) * P // DIST_WORLD
            k1 = r["k1"][qname]
            err = compare(f"[dist-gloo] K1 {qname} rank {k}", k1["kernel"], k1["plain"],
                          {1} if args[2] is None else {2})
            checks[kname] = max(checks[kname], err)
            check(all(torch.equal(a, b[lo_:hi_].cpu()) for a, b in zip(k1["kernel"], full)),
                  f"[dist-gloo] K1 {qname}: rank {k}'s launch differs from the "
                  "one-process launch's rows")
            errs.append(err)
        say("dist-gloo", check=f"K1 {kname}", rank_shape=k1["shape"], max_abs_err_vs_plain=errs,
            vs_one_process_launch_rows="bitwise")
    for family in ("single", "synchronized"):
        got = dist_phase("dist-fault", "gloo", f"fault q1-small {family}",
                         _to_cpu(faulted["q1-small", family]), group_k,
                         e2e[f"fault q1-small {family}"])
        check(all(g_["out"][1] == {FAIL_P: FAIL_R} for g_ in got),
              f"[dist-fault] {family}: a rank recorded another failure")
    got = dist_phase("dist-fault", "gloo", "fault-stream q6", _to_cpu(faulted["q6", "single"]),
                     scalar_k, e2e["fault-stream q6"],
                     extra={"failing_source_on_rank": FAIL_P // (P // DIST_WORLD)})
    recorded = [g_["out"][1] for g_ in got]
    check(recorded == [{FAIL_P: FAIL_R}] * DIST_WORLD,
          f"[dist-fault] streamed loss recorded as {recorded}")
    say("dist-fault", run="fault-stream q6", recorded_fail_at_per_rank=recorded)
    # [dist-elastic]: the W=4 envelopes against the one-process pauses, then
    # resumed here on P=8 (bitwise) and on W=2 ranks at partitions=4
    from repro_torch import ckpt as CK

    cols = {k: shards[k] for k in STREAM_COLS}
    for qname, gla, kernel in streamed[:2]:
        got = [r["phases"][f"pause {qname}"] for r in ranks["gloo"]]
        check(all(g_["launches"] == {kernel: DIST_AT} for g_ in got),
              f"[dist-elastic] pause {qname}: launches {[g_['launches'] for g_ in got]}")
        for g_ in got:
            rank_launches[kernel] += g_["launches"][kernel]
        ck_d = work / "dist" / f"elastic-{qname}.ckpt"
        meta_d, blob_d = CK.load_envelope(ck_d)
        meta_1, blob_1 = CK.load_envelope(work / f"elastic-{qname}.ckpt")
        like = T.Session(spec(gla), cols, device=dev)._payload_like(DIST_AT)
        check(same(CK.deserialize_state(blob_d, like), CK.deserialize_state(blob_1, like)),
              f"[dist-elastic] {qname}: the W=4 envelope's leaves differ from one process's")
        keys = ("P", "C", "L", "schedule", "cursors", "steps", "path", "fail_at")
        check(all(meta_d[k] == meta_1[k] for k in keys),
              f"[dist-elastic] {qname}: the W=4 envelope's plan differs from one process's")
        FK.reset_launch_counts()
        t0 = time.perf_counter()
        here = drive(T.Session.resume(ck_d, gla, cols, device=dev))
        torch.cuda.synchronize()
        t_here = time.perf_counter() - t0
        path_launches(f"dist-elastic {qname}: resumed in one process",
                      {kernel: ROUNDS - DIST_AT})
        check(same(here, twins[qname]),
              f"[dist-elastic] {qname}: the W=4 envelope resumed on P=8 differs")
        say("dist-elastic", run=f"pause {qname}", paused_at=DIST_AT,
            checkpoint_bytes=ck_d.stat().st_size, envelope_leaves_vs_one_process="bitwise",
            pause_s=[f"{g_['out']:.3f}" for g_ in got],
            collective_s_per_round=[f"{g_['collective_s_per_round']:.6f}" for g_ in got],
            gathered_bytes_per_round=[int(g_["gathered_bytes_per_round"]) for g_ in got],
            peak_device_bytes=[g_["peak_bytes"] for g_ in got],
            resumed_in_one_process_P8="bitwise", one_process_resume_s=f"{t_here:.3f}")
        dist_phase("dist-elastic", "resume", f"resume {qname}", _to_cpu(twins[qname]),
                   {kernel: ROUNDS - DIST_AT}, e2e[f"elastic {qname} 8->4"], exact=False,
                   extra={"world": 2, "partitions": 4})
        check(all(same(r["phases"][f"resume {qname}"]["out"], _to_cpu(elastic_res[qname, (4,)]))
                  for r in ranks["resume"]),
              f"[dist-elastic] {qname}: W=2 at partitions=4 differs from one process at 4")
        say("dist-elastic", run=f"resume {qname}",
            vs_one_process_resume_at_4="bitwise")
    peaks = [g_["peak_bytes"] for job in ranks.values() for r in job for g_ in r["phases"].values()]
    card_peak = held + sum(max(g_["peak_bytes"] for g_ in r["phases"].values())
                           for job in ("gloo", "nccl") for r in ranks[job])
    check(card_peak < 0.75 * torch.cuda.get_device_properties(0).total_memory,
          f"[dist] the processes' peak device memory sums to {card_peak} B")
    say("dist", ranks_peak_device_bytes_max=max(peaks), parent_held_bytes=held,
        card_peak_bytes_bound=card_peak,
        card_used_bytes_at_rank_end=[r.get("card_used_bytes") for job in ranks.values()
                                     for r in job],
        card_total_bytes=torch.cuda.get_device_properties(0).total_memory,
        rank_launches={k: n for k, n in rank_launches.items() if n})
    for k, n in rank_launches.items():
        launches[k] += n

    # -- 4d. serving: one shared scan, many queries (repro_torch.service) ---
    # The reference service's slot family plus `supp` (2^13 buckets), at
    # the service's 8 rounds: each live bank of K slots is one K-member K1
    # bundle, ceil(K/16) pf_bundle launches a step.  [serve] holds every
    # late joiner bitwise to a solo session over the ranges it witnessed and
    # the full pass to the oracle; [serve-churn] the step-plan bound under
    # churn; [serve-svc] the asyncio service to the oracle; [serve-stream]
    # the streamed copies and [serve-dist] four gloo ranks bitwise to
    # [serve].  Each phase's peak device memory is above what was allocated
    # before it (the resident table among it).
    import asyncio

    import numpy as np

    from repro_torch import service as SV

    fam = serve_family()
    sw = C // SERVE_ROUNDS  # chunks a partition in one serving step
    bundle_k = "fused_round_step/bundle"

    def mem_base():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def slot_exact(q):
        """The float64 oracle of one slot query over the whole table."""
        fs = fam.solo_gla(q, d_total=d).fused
        if fs.group is None:
            return exact_of(fs)[0]
        return exact_of(fs, group=fs.group, num_groups=fs.num_groups)

    # the HAVING threshold: halfway between the 2nd and 3rd of the four group
    # estimates the late joiner ends with, from its rounds in float64, so
    # that two groups pass and two do not
    hq = serve_queries(0.0)["having"]._replace(having=None)
    hfs = fam.solo_gla(hq, d_total=d).fused
    win = {k: shards[k][:, SERVE_JOIN * sw:(SERVE_JOIN + SERVE_LATE) * sw].reshape(-1)
           for k in ("shipdate", "discount", "quantity", "rfls", "_mask")}
    g_sums = tpch.exact_answer(win, hfs.func, hfs.cond, group=hfs.group, num_groups=4)[:, 0]
    g_est = sorted((d / float(win["_mask"].sum(dtype=torch.float64)) * g_sums).tolist())
    having = (g_est[1] + g_est[2]) / 2
    del win
    qs = serve_queries(having)

    # [serve]: the scalar slot from round 0; four slots join at round 3
    late_all = ("late", "rfls", "supp", "having")
    op_err = []

    def operands(scan_, tag="serve"):
        """The next step's bundle operands of every bank against the plain
        version (counters exact, sums within SUM_RTOL); these launches do
        not count.  Returns the largest |kernel - plain|."""
        seg = FK.launch_counts()
        r = scan_.cursor % scan_.rounds
        cols = {k: v[:, r * sw:(r + 1) * sw] for k, v in shards.items()}
        errs = [0.0]
        for name in scan_.banks:
            gla, states, path = scan_.step_inputs(name)
            check(path == "kernel_fused", f"[{tag}] bank {name} routes to {path}")
            args = [FK._member_args(m.fused, st, cols) for m, st in zip(gla.members, states)]
            got_, want_ = FK.bundle_round_step(args), ref.bundle_round_step(args)
            for m, a, r_ in zip(args, got_, want_):
                if m[2] is None:
                    A = m[0].shape[-1]
                    errs.append(compare(f"[{tag}] {name} operands", (a[:, :2 * A], a[:, 2 * A]),
                                        (r_[:, :2 * A], r_[:, 2 * A]), {1}))
                else:
                    errs.append(compare(f"[{tag}] {name} operands", a, r_, {2}))
            del args, got_, want_
        torch.cuda.synchronize()
        FK.reset_launch_counts()
        FK.LAUNCHES.update(seg)
        return max(errs)

    FK.reset_launch_counts()
    base = mem_base()
    t0 = time.perf_counter()
    scan_r = T.SharedScan(fam, shards, rounds=SERVE_ROUNDS, device=dev)
    check(scan_r.rounds == SERVE_ROUNDS and scan_r.width == sw and scan_r.d_total == d,
          f"[serve] scan of {scan_r.rounds} rounds of {scan_r.width} chunks, d={scan_r.d_total}")
    recs, held, step_s = serve_schedule(scan_r, qs, late_all,
                                        hook=lambda s_: op_err.append(operands(s_)))
    e2e["serve"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    got = path_launches("serve", serve_launches(late_all))
    checks[bundle_k] = max(checks[bundle_k], *op_err)
    banks = {n: b.K for n, b in scan_r.banks.items()}
    check(banks == {"scalar": 2, "rfls": 1, "supp": 1, "rfls:having": 1},
          f"[serve] bank capacities {banks}")
    # every late joiner bitwise a solo Session(emit="kernel") over its ranges
    ranges = held["late"][1]
    check(all(h[1] == ranges for h in held.values())
          and [lo for lo, _ in ranges] == [c * sw for c in range(SERVE_JOIN, SERVE_JOIN + SERVE_LATE)],
          f"[serve] witnessed ranges {ranges}")

    def solo_twin(tag, q, ranges_, est, view):
        """A fresh Session(emit="kernel") over ``view`` (the ranges a slot
        witnessed): the slot's estimate, lower and upper must be its last
        round's, bitwise.  Returns the session's seconds."""
        gla = fam.solo_gla(q, d_total=d)
        kname = "fused_round_step/" + ("scalar" if q.group is None else "group")
        FK.reset_launch_counts()
        t0 = time.perf_counter()
        sess = T.Session(T.QuerySpec(gla, rounds=len(ranges_), emit="kernel"), view,
                         device=dev)
        while not sess.done:
            prog = sess.step()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        path_launches(f"{tag}: solo {q}", {kname: len(ranges_)})
        check(all(torch.equal(a, b) for a, b in zip(est[:3], prog.estimates[:3])),
              f"[{tag}] slot {q} differs from its solo session")
        return secs

    view = SV.witnessed_view(shards, ranges)
    solo_s = {n: solo_twin("serve", qs[n], ranges, held[n][0], view) for n in late_all}
    del view
    keep = held["having"][0].info["keep"].reshape(-1)
    check(keep.min().item() == 0 and keep.max().item() == 1,
          f"[serve] the HAVING threshold passes groups {keep.tolist()}")
    # the full-pass slot: its estimate is the whole table's answer
    full = recs["scalar"]
    check(full.done and not full.converged and len(full.witnessed) == SERVE_ROUNDS
          and full.scanned == scan_r.d_total, "[serve] the scalar slot's full pass")
    ex_full = slot_exact(qs["scalar"])
    err_full = abs(float(full.estimate.estimate) - float(ex_full)) / abs(float(ex_full))
    check(err_full <= ORACLE_RTOL, f"[serve] full-pass estimate off the oracle by {err_full:.3e}")
    say("serve", rows=ROWS, rounds=SERVE_ROUNDS, chunks_per_step=sw, banks=banks,
        step_plans={n: sorted(b.plans) for n, b in scan_r.banks.items()},
        having_threshold=having, having_keep=keep.int().tolist(),
        late_joiners_vs_solo_session="bitwise", operands_vs_plain_max_abs_err=max(op_err),
        full_pass_rel_err=f"{err_full:.3e}",
        step_s=[f"{x:.6f}" for x in step_s], seconds=f"{e2e['serve']:.3f}",
        solo_session_s={n: f"{x:.3f}" for n, x in solo_s.items()},
        peak_device_bytes=peak, launches=got)

    # [serve-churn]: five arrivals and two departures a step grow the scalar
    # bank to K=32 (two pf_bundle launches a step) from its fifth step, when
    # four `supp` slots open a group bank at K=4.  That step's operands are
    # held against the plain version, and slots of both banks (of both
    # launches of the scalar bank) bitwise against their solo sessions.
    rng = np.random.default_rng(SEED)
    FK.reset_launch_counts()
    base = mem_base()
    plans0 = SV.serve_step_cache_sizes()
    t0 = time.perf_counter()
    scan_c = T.SharedScan(fam, shards, rounds=SERVE_ROUNDS, device=dev)
    live, gens, ks, churn_s, every, supp_recs = [], {}, [], [], [], []
    arrivals = reclaims = want = 0
    churn_err = None
    for step in range(SERVE_ROUNDS):
        for _ in range(5):
            lo_ = float(rng.integers(0, 2000))
            q = T.SlotQuery("q6" if arrivals % 2 else "qty",
                            {"shipdate": (lo_, lo_ + 500.0),
                             "discount": (0.0, float(rng.uniform(0.03, 0.11)))})
            bank = scan_c.banks.get("scalar")
            free = None if bank is None or None not in bank.slots else bank.slots.index(None)
            rec = scan_c.attach(q)
            check(rec.generation == gens.get(rec.slot, 0) + 1
                  and (free is None or rec.slot == free),
                  f"[serve-churn] slot {rec.slot} at generation {rec.generation}")
            reclaims += rec.generation > 1
            gens[rec.slot] = rec.generation
            live.append(rec)
            every.append(rec)
            arrivals += 1
        for j in sorted(rng.choice(len(live), 2, replace=False), reverse=True):
            scan_c.detach(live.pop(int(j)))
        if step == SERVE_CHURN_SUPP:
            supp_recs = [scan_c.attach(T.SlotQuery(["qty", "q6"][i % 2],
                                                   {"shipdate": (200.0 * i, 2200.0)},
                                                   group="supp")) for i in range(4)]
        bank = scan_c.banks["scalar"]
        ks.append(bank.K)
        want += sum(-(-b.K // FK.MAX_BUNDLE_MEMBERS) for b in scan_c.banks.values() if b.active)
        if bank.K == 32 and churn_err is None:
            churn_err = operands(scan_c, "serve-churn")
        t1 = time.perf_counter()
        out = scan_c.step()
        torch.cuda.synchronize()
        churn_s.append(time.perf_counter() - t1)
        for rec, prog in out:
            e = prog.estimates
            check(bool(torch.isfinite(e.estimate).all() and (e.lower <= e.upper).all()),
                  f"[serve-churn] slot {rec.slot}: estimate or bounds")
            if rec.done:
                scan_c.detach(rec)
                live.remove(rec)
    e2e["serve-churn"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    got = path_launches("serve-churn", {bundle_k: want})
    check(churn_err is not None and scan_c.banks["supp"].K == 4,
          f"[serve-churn] K {ks}: no K=32 step, or supp at K={scan_c.banks['supp'].K}")
    checks[bundle_k] = max(checks[bundle_k], churn_err)
    bank = scan_c.banks["scalar"]
    built = SV.serve_step_cache_sizes() - plans0
    check(max(ks) == 32 and all(len(b.plans) <= 1 + b.doublings for b in scan_c.banks.values())
          and built == scan_c.compile_budget() < arrivals and reclaims > 0,
          f"[serve-churn] K {ks}, plans {[sorted(b.plans) for b in scan_c.banks.values()]}, "
          f"built {built}, doublings {bank.doublings}, arrivals {arrivals}, "
          f"reclaims {reclaims}")
    # slots that rode the K=32 steps, in the first and the second launch,
    # and two supp slots, each bitwise its solo session
    k32 = {i * sw for i, k in enumerate(ks) if k == 32}  # ranges stepped at K=32
    churn_twins = ([r for r in every if r.slot >= 16 and len(r.witnessed) >= 2][:2]
             + [r for r in every if r.slot < 16 and 2 <= len(r.witnessed) <= 4
                and any(lo in k32 for lo, _ in r.witnessed)][:1] + supp_recs[:2])
    check(len(churn_twins) == 5,
          f"[serve-churn] {len(churn_twins)} slots to hold against solo sessions")
    twin_s = []
    for rec in churn_twins:
        view = SV.witnessed_view(shards, rec.witnessed)
        twin_s.append(solo_twin("serve-churn", rec.query, rec.witnessed, rec.estimate, view))
        del view
    say("serve-churn", arrivals=arrivals, departures=arrivals - len(live), reclaims=reclaims,
        capacity_per_step=ks, bundle_launches_per_step=[-(-k // 16) for k in ks],
        supp_capacity=scan_c.banks["supp"].K,
        step_plans={n: sorted(b.plans) for n, b in scan_c.banks.items()},
        doublings=bank.doublings, plans_built=built,
        k32_operands_vs_plain_max_abs_err=churn_err,
        slots_vs_solo_session={f"{r.bank}:{r.slot}": len(r.witnessed) for r in churn_twins},
        solo_session_s=[f"{x:.3f}" for x in twin_s],
        step_s=[f"{x:.6f}" for x in churn_s], seconds=f"{e2e['serve-churn']:.3f}",
        peak_device_bytes=peak, launches=got)
    del scan_c, live, out, every, supp_recs, churn_twins

    # [serve-svc]: benchmarks/serve.py's Poisson stream through OLAService,
    # then the same queries as one Session each, run one after another.
    # submit() is timed on its own (the first one builds the scan and
    # fingerprints the table); time-to-eps runs from submit to result.
    arr, queries = serve_stream(SERVE_N, SERVE_QPS)
    real_step = SV.SharedScan.step

    def counting(want):
        """``SharedScan.step``, adding to ``want`` the launches it must make."""
        def step(self_):
            want[bundle_k] += bank_launches(self_)
            return real_step(self_)
        return step

    async def drive_shared():
        async with SV.OLAService(fam, rounds=SERVE_ROUNDS, grace_s=SERVE_GRACE,
                                 device=dev) as svc:
            outs, t_eps, t_sub, makespan, _ = await serve_arrivals(svc, shards, arr,
                                                                   queries, SERVE_EPS)
            first = svc.scan_for(shards)
            steps = first.steps_done
            await asyncio.sleep(6 * SERVE_GRACE)
            parked = svc.is_parked(shards)
            h = await svc.submit(T.QuerySpec(queries[0], stop=T.rel_width(SERVE_EPS)), shards)
            after = await h.result()
            reused = svc.scan_for(shards) is first and first.steps_done > steps
        return outs, t_eps, t_sub, makespan, steps, parked, after, reused

    svc_want = {bundle_k: 0}
    FK.reset_launch_counts()
    base = mem_base()
    SV.SharedScan.step = counting(svc_want)
    try:
        outs, t_eps, t_sub, makespan, steps, parked, after, reused = asyncio.run(
            asyncio.wait_for(drive_shared(), 300))
    finally:
        SV.SharedScan.step = real_step
    peak = torch.cuda.max_memory_allocated() - base
    got = path_launches("serve-svc", svc_want)
    check(parked and reused, f"[serve-svc] parked={parked}, the same scan reused={reused}")
    exacts = {}

    def oracle_check(tag, qs_, outs_):
        """Every outcome against the float64 oracle of its query over the
        whole table: within 3 half-widths when its rule stopped it, else
        (a full pass) within ORACLE_RTOL.  Returns the largest relative
        error."""
        err_max = 0.0
        for q, o in zip(qs_, outs_):
            key = (q.expr, tuple(sorted(q.ranges.items())), q.group)
            if key not in exacts:  # the float64 oracle, once per distinct query
                exacts[key] = slot_exact(q).cpu()
            ex = exacts[key].reshape(o.estimate.estimate.shape)  # outcomes are on the CPU
            est, lo_, hi_ = (x.double() for x in o.estimate[:3])
            err = (est - ex).abs()
            bound = (3 * (hi_ - lo_) / 2 if o.converged else 0.0) + ORACLE_RTOL * ex.abs()
            check(bool((err <= bound).all()),
                  f"[{tag}] {q}: off the oracle (converged={o.converged})")
            err_max = max(err_max, (err / ex.abs().clamp(min=1e-300)).max().item())
        return err_max

    err_max = oracle_check("serve-svc", queries + [queries[0]], outs + [after])

    def one_session_per_query(tag, qs_, arr_, rounds, eps):
        """The contender: one Session(emit="kernel", stop=rel_width(eps))
        per query, one after another from the same arrival times, held to
        its launches.  Returns (time-to-eps a query, makespan, launches)."""
        FK.reset_launch_counts()
        want_, eps_s, clock = {}, [], 0.0
        for i, q in enumerate(qs_):
            gla = fam.solo_gla(q, d_total=d)
            t1 = time.perf_counter()
            sess = T.Session(T.QuerySpec(gla, rounds=rounds, emit="kernel",
                                         stop=T.rel_width(eps)), shards, device=dev)
            sess.run()
            torch.cuda.synchronize()
            dur = time.perf_counter() - t1
            kname = "fused_round_step/" + ("scalar" if q.group is None else "group")
            want_[kname] = want_.get(kname, 0) + sess.steps_taken
            clock = max(float(arr_[i]), clock) + dur
            eps_s.append(clock - float(arr_[i]))
        path_launches(f"{tag}: one session per query", want_)
        return eps_s, clock - float(arr_[0]), want_

    solo_eps, solo_mk, solo_want = one_session_per_query(
        "serve-svc", queries, arr, SERVE_ROUNDS, SERVE_EPS)
    pct = [50, 99]
    p50s, p99s = np.percentile(t_eps, pct) * 1e3
    p50o, p99o = np.percentile(solo_eps, pct) * 1e3
    p50u, p99u = np.percentile(t_sub[1:], pct) * 1e3
    rounds_seen = {n: sum(o.rounds_witnessed == n for o in outs)
                   for n in sorted({o.rounds_witnessed for o in outs})}
    e2e["serve-svc"] = makespan
    say("serve-svc", queries=SERVE_N, qps_offered=SERVE_QPS, eps=SERVE_EPS,
        qps_shared=SERVE_N / makespan, qps_one_session_per_query=SERVE_N / solo_mk,
        p50_time_to_eps_ms=p50s, p99_time_to_eps_ms=p99s,
        p50_time_to_eps_one_session_ms=p50o, p99_time_to_eps_one_session_ms=p99o,
        first_submit_ms=t_sub[0] * 1e3, p50_submit_ms=p50u, p99_submit_ms=p99u,
        shared_scan_steps=steps, converged=sum(o.converged for o in outs),
        queries_by_rounds_witnessed=rounds_seen, distinct_queries=len(exacts),
        oracle_max_rel_err=f"{err_max:.3e}", parked_then_reused=True,
        peak_device_bytes=peak, launches=got, one_session_launches=solo_want)

    # [serve-svc-long]: the same queries at SERVE_LONG_ROUNDS rounds, at
    # SERVE_LONG_QPS, with an eps at which they need several rounds: the
    # median query's round-1 relative half-width shrunk by the finite-
    # population factor to round SERVE_LONG_AT.  The round-1 half-widths
    # come from one step of a scan with every distinct query attached.
    R = SERVE_LONG_ROUNDS
    arr_l, queries_l = serve_stream(SERVE_N, SERVE_LONG_QPS)

    def key_of(q):
        return (q.expr, tuple(sorted(q.ranges.items())), q.group)

    distinct = {key_of(q): q for q in queries_l}
    scan1 = T.SharedScan(fam, shards, rounds=R, device=dev)
    recs1 = {k: scan1.attach(q) for k, q in distinct.items()}
    want1 = {bundle_k: bank_launches(scan1)}
    FK.reset_launch_counts()
    scan1.step()
    path_launches("serve-svc-long: round 1", want1)

    def rel_width_of(e):  # what rel_width(eps) compares with eps
        half = (e.upper.double() - e.lower.double()) / 2
        mid = e.estimate.double().abs().clamp(min=1e-300)
        return torch.where(half == 0, 0.0, half / mid).max().item()

    rel1 = {k: rel_width_of(r.estimate) for k, r in recs1.items()}
    del scan1, recs1
    per_query = np.array([rel1[key_of(q)] for q in queries_l])
    shrink = math.sqrt((R / SERVE_LONG_AT - 1) / (R - 1))
    eps_l = float(np.median(per_query)) * shrink * 1.0001
    svc_want = {bundle_k: 0}
    FK.reset_launch_counts()
    base = mem_base()

    async def drive_long():
        async with SV.OLAService(fam, rounds=R, grace_s=SERVE_GRACE, device=dev) as svc:
            got_ = await serve_arrivals(svc, shards, arr_l, queries_l, eps_l)
            return got_, svc.scan_for(shards).steps_done

    SV.SharedScan.step = counting(svc_want)
    try:
        (outs_l, t_eps_l, _, mk_l, _), steps_l = asyncio.run(
            asyncio.wait_for(drive_long(), 300))
    finally:
        SV.SharedScan.step = real_step
    peak = torch.cuda.max_memory_allocated() - base
    got = path_launches("serve-svc-long", svc_want)
    err_l = oracle_check("serve-svc-long", queries_l, outs_l)
    witnessed_l = [o.rounds_witnessed for o in outs_l]
    median_l = float(np.median(witnessed_l))
    in_flight = sum(t_eps_l) / mk_l  # Little's law over the makespan
    check(3 <= median_l <= 6, f"[serve-svc-long] the median query witnessed {median_l} rounds")
    check(in_flight >= 4, f"[serve-svc-long] {in_flight:.2f} queries in flight on average")
    solo_eps_l, solo_mk_l, solo_want_l = one_session_per_query(
        "serve-svc-long", queries_l, arr_l, R, eps_l)
    e2e["serve-svc-long"] = mk_l
    long_line = dict(
        queries=SERVE_N, rounds=R, qps_offered=SERVE_LONG_QPS, eps=eps_l,
        round1_rel_half_width=dict(zip(("min", "p25", "median", "p75", "max"), (
            float(x) for x in np.percentile(per_query, [0, 25, 50, 75, 100])))),
        median_rounds_witnessed=median_l,
        queries_by_rounds_witnessed={n: witnessed_l.count(n) for n in sorted(set(witnessed_l))},
        mean_in_flight=in_flight, qps_shared=SERVE_N / mk_l,
        qps_one_session_per_query=SERVE_N / solo_mk_l,
        p50_time_to_eps_ms=np.percentile(t_eps_l, 50) * 1e3,
        p99_time_to_eps_ms=np.percentile(t_eps_l, 99) * 1e3,
        p50_time_to_eps_one_session_ms=np.percentile(solo_eps_l, 50) * 1e3,
        p99_time_to_eps_one_session_ms=np.percentile(solo_eps_l, 99) * 1e3)
    say("serve-svc-long", **long_line, shared_scan_steps=steps_l,
        converged=sum(o.converged for o in outs_l), oracle_max_rel_err=f"{err_l:.3e}",
        peak_device_bytes=peak, launches=got, one_session_launches=solo_want_l)

    # [serve-stream]: the [serve] schedule over the npy and the encoded copy
    # (no `supp` slot: the copies hold no suppkey), bitwise the [serve] run
    late_s = ("late", "rfls", "having")
    for sname, src in (("npy", npy_src), ("encoded", enc_src)):
        FK.reset_launch_counts()
        base = mem_base()
        t0 = time.perf_counter()
        scan_s = T.SharedScan(fam, src, rounds=SERVE_ROUNDS, device=dev)
        try:
            recs_s, held_s, secs_s = serve_schedule(scan_s, qs, late_s)
            io = scan_s.io_stats
        finally:
            scan_s.close()
        e2e[f"serve-stream {sname}"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        want = serve_launches(late_s)
        if src.encodings:
            want["decode"] = SERVE_ROUNDS  # one decode a step, for every bank
        got = path_launches(f"serve-stream {sname}", want)
        check(all(same(held_s[n][0], held[n][0]) and held_s[n][1] == held[n][1]
                  for n in late_s)
              and same(recs_s["scalar"].estimate, full.estimate)
              and recs_s["scalar"].scanned == full.scanned,
              f"[serve-stream] {sname}: differs from the resident [serve] run")
        say("serve-stream", source=sname, slots=["scalar", *late_s],
            vs_resident_serve="bitwise", step_s=[f"{x:.6f}" for x in secs_s],
            seconds=f"{e2e[f'serve-stream {sname}']:.3f}",
            resident_seconds=f"{e2e['serve']:.3f}", h2d_bytes_per_step=io["bytes"] // io["slices"],
            host_read_s=io["read_s"], h2d_copy_ms=io["copy_ms"], waited_s=io["wait_s"],
            peak_device_bytes=peak, launches=got)
    del scan_s, recs_s, held_s

    # [serve-dist]: four gloo ranks sharing the card, each over 2 partitions
    # of the npy copy, with [serve-stream]'s slots, bitwise the [serve] run
    (work / "dist").mkdir(exist_ok=True)
    (work / "dist" / "serve.json").write_text(json.dumps({"having": having}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks_s = spawn_ranks({"serve": DIST_WORLD}, work)["serve"]
    t_spawn = time.perf_counter() - t0
    want = serve_launches(late_s)
    cpu = {n: _to_cpu(held[n]) for n in late_s}
    full_cpu = _to_cpu((full.estimate, full.scanned))
    for k, r in enumerate(ranks_s):
        g_ = r["phases"]["serve"]
        o = g_["out"]
        check(all(same(o["held"][n][0], cpu[n][0]) and o["held"][n][1] == cpu[n][1]
                  for n in late_s) and same(o["scalar"][0], full_cpu[0])
              and o["scalar"][1] == full_cpu[1],
              f"[serve-dist] rank {k}'s slots differ from the one-process [serve] run")
        check(g_["launches"] == want,
              f"[serve-dist] rank {k} launched {g_['launches']}, expected {want}")
        for kn, n in g_["launches"].items():
            launches[kn] += n
    gs = [r["phases"]["serve"] for r in ranks_s]
    say("serve-dist", ranks=DIST_WORLD, backend="gloo", partitions_per_rank=P // DIST_WORLD,
        vs_one_process="bitwise", seconds=[f"{g_['seconds']:.3f}" for g_ in gs],
        one_process_seconds=f"{e2e['serve']:.3f}",
        step_s_rank0=[f"{x:.6f}" for x in gs[0]["out"]["step_s"]],
        collective_s_per_step=[f"{g_['collective_s_per_round']:.6f}" for g_ in gs],
        gathered_bytes_per_step=[int(g_["gathered_bytes_per_round"]) for g_ in gs],
        collectives=[g_["collectives"] for g_ in gs],
        peak_device_bytes=[g_["peak_bytes"] for g_ in gs], spawn_to_end_s=f"{t_spawn:.3f}",
        launches_per_rank=gs[0]["launches"])

    # [serve-dist-svc] and the ranks' [serve-svc-long]: four gloo ranks, 2
    # partitions of the npy copy each, serve [serve-svc]'s and
    # [serve-svc-long]'s streams through OLAService(mesh=): rank 0 takes the
    # arrivals, the others follow.  Every rank applies rank 0's operation log
    # and holds rank 0's scan digest after every step; one process replaying
    # that log over the whole resident table gives every outcome bitwise.
    (work / "dist" / "serve-svc.json").write_text(json.dumps({"eps": eps_l}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks_v = spawn_ranks({"serve-svc": DIST_WORLD}, work)["serve-svc"]
    t_spawn = time.perf_counter() - t0
    for name, rounds, eps, qs_ in (("serve-dist-svc", SERVE_ROUNDS, SERVE_EPS, queries),
                                   ("serve-svc-long", R, eps_l, queries_l)):
        gs = [r["phases"][name] for r in ranks_v]
        r0 = gs[0]["out"]
        log, steps_v = gs[0]["log"], r0["steps"]
        check(len(gs[0]["digests"]) == steps_v and steps_v > 0,
              f"[{name}] rank 0 recorded {len(gs[0]['digests'])} digests of {steps_v} steps")
        for k, g_ in enumerate(gs):
            check(g_["log"] == log, f"[{name}] rank {k} applied another operation log")
            check(g_["digests"] == gs[0]["digests"],
                  f"[{name}] rank {k}'s scan differs from rank 0's after a step")
            want = {bundle_k: g_["want"]} if g_["want"] else {}
            check(g_["launches"] == want,
                  f"[{name}] rank {k} launched {g_['launches']}, expected {want}")
            for kn, n in g_["launches"].items():
                launches[kn] += n
        scan_rp = T.SharedScan(fam, shards, rounds=rounds, device=dev)
        FK.reset_launch_counts()
        t0 = time.perf_counter()
        recs_rp, dig_rp, want_rp = replay_log(scan_rp, log, steps_v, eps)
        torch.cuda.synchronize()
        t_rp = time.perf_counter() - t0
        path_launches(f"{name}: one-process replay", {bundle_k: want_rp})
        check(dig_rp == gs[0]["digests"], f"[{name}] the one-process replay's scan differs")
        for n, i in enumerate(r0["order"]):
            est, scanned, rounds_w, conv = r0["outcomes"][i]
            rec = recs_rp[n]
            check(same(tuple(est[:3]), _to_cpu(tuple(rec.estimate[:3])))
                  and scanned == rec.scanned and rounds_w == len(rec.witnessed)
                  and conv == rec.converged,
                  f"[{name}] query {i} differs from its one-process replay")
        del scan_rp, recs_rp
        rw = [o[2] for o in r0["outcomes"]]
        say(name, ranks=DIST_WORLD, backend="gloo", partitions_per_rank=P // DIST_WORLD,
            queries=len(qs_), rounds=rounds, eps=eps, qps=len(qs_) / r0["makespan"],
            p50_time_to_eps_ms=np.percentile(r0["t_eps"], 50) * 1e3,
            p99_time_to_eps_ms=np.percentile(r0["t_eps"], 99) * 1e3,
            median_rounds_witnessed=float(np.median(rw)),
            mean_in_flight=sum(r0["t_eps"]) / r0["makespan"], steps=steps_v,
            step_ms_rank0={q: float(np.percentile(gs[0]["step_s"], q) * 1e3)
                           for q in (50, 99, 100)},
            send_and_step_ms_rank0={q: float(np.percentile(gs[0]["tick_s"], q) * 1e3)
                                    for q in (50, 99)},
            record_ms={q: [float(np.percentile(g_["record_s"], q) * 1e3) for g_ in gs]
                       for q in (50, 99)},
            records=[len(g_["record_s"]) for g_ in gs],
            operations=len(log), digests_equal_every_step=True,
            vs_one_process_replay="bitwise", replay_s=f"{t_rp:.3f}",
            collective_s_per_step=[f"{g_['collective_s_per_round'] / steps_v:.6f}" for g_ in gs],
            collective_bytes_per_step=[int(g_["gathered_bytes_per_round"] / steps_v) for g_ in gs],
            collectives_per_step=[round(g_["collectives"] / steps_v, 3) for g_ in gs],
            seconds=[f"{g_['seconds']:.3f}" for g_ in gs],
            one_process_seconds=f"{e2e['serve-svc' if name == 'serve-dist-svc' else name]:.3f}",
            peak_device_bytes=[g_["peak_bytes"] for g_ in gs], spawn_to_end_s=f"{t_spawn:.3f}",
            launches_per_rank=[g_["launches"] for g_ in gs])

    # -- 4e. plan trees, the sketch GLAs, the monotone envelope and the eval
    # bridge: each path held to its own launch counts, as above
    ctx = types.SimpleNamespace(
        dev=dev, d=d, shards=shards, flat=flat, enc_src=enc_src, orders=orders,
        nation=nation, exact1s=exact1s, path_launches=path_launches, e2e=e2e,
        glas={"q6": q6, "q1-small": q1s, "q1-large": q1l, "nation": jn, "q3": q3})
    having = plan_phase(ctx)
    envelope_phase(ctx, having)
    sketch_phase(ctx)
    eval_phase(ctx)
    ctx.npy_src = npy_src
    audit_phase(ctx)
    # -- 4f. the loading side: the streamed sessions read from a parquet
    # copy, and the paper's distributed randomization
    ctx.__dict__.update(exact6=exact6, smi=smi, work=work, streamed=streamed, twins=twins,
                        same=same)
    parquet_phase(ctx)
    randomize_phase(ctx)
    # -- 4g. the LM serving path of the dense family, and the online eval
    # over its forward (K2, K1 scalar)
    lm_serve_phase(ctx)
    lm_serve_7b_phase(ctx)
    lm_widths_phase(ctx)
    # -- 4h. training (dense family), then the online eval over the trained
    # weights, as examples/online_eval.py orders them
    lm_train_phase(ctx)
    lm_train_7b_phase(ctx)
    lm_adaptive_phase(ctx)
    lm_eval_phase(ctx)
    # -- 4i. the dry run of every cell, one cell against the card, the
    # hill-climb's terms and the contract linters (no kernel of the path)
    dryrun_phase(ctx, dry, t_dry, dry_out)
    shutil.rmtree(dry_out, ignore_errors=True)

    say("main-path launches", **launches)
    for k, n in launches.items():
        if k in OFF_PATH:
            check(n == 0, f"kernel {k} launched on the main path, which has none")
        else:
            check(n > 0, f"kernel {k} was not launched on the main path")

    # -- 5. timing: kernel, plain version, library call, closures included --
    def device_ms(fn):
        """Device ms per call of every kernel ``fn`` launches (a trace)."""
        return phases(fn, {})["other_ms"]

    #: pf_scalar's two grids (K1 scalar, K2), once per call each
    scalar_split = {"partials_ms": ("scalar_partials", 1), "fold_ms": ("scalar_fold", 1)}

    def tiles(C_, members):
        """Tiles of chunks the group step takes (``ops.group_step_tile``)."""
        return -(-C_ // ops.group_step_tile(C_, L, members))

    def bound(nbytes, flops):
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    def stacked(vals, w):
        """The library call's operand: (v·w, v·v·w, w) per row, [rows, 2A+1]."""
        vw = vals * w[..., None]
        return torch.cat([vw, vals * vw, w[..., None]], dim=-1).reshape(-1, 2 * vals.shape[-1] + 1)

    def stacked_rows_last(vals, w):
        """The same for the scalar kernels, [P, 3, rows] (rows innermost)."""
        return stacked(vals, w).reshape(P, -1, 3).transpose(1, 2).contiguous()

    rows = []

    def record(name, replaces, ms, plain_ms, nbytes, flops, library_ms, extra):
        b, by = bound(nbytes, flops)
        rows.append({
            "name": name, "route": "cuda", "source": CSRC + SOURCES[name],
            "replaces": replaces,
            "launches": launches[name], "max_abs_err": checks[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": library_ms})
        say("time", kernel=name, ms=f"{ms:.6f}", plain_ms=f"{plain_ms:.6f}",
            bound_ms=f"{b:.6f}", bound_by=by, library_ms=library_ms,
            bytes=nbytes, flops=flops, **extra)

    # K1 scalar on one round-slice
    N = vals6.numel()
    x = stacked_rows_last(vals6, w6)
    st6 = scan.stack_init(q6, (P,), dev)
    record("fused_round_step/scalar", K1,
           median_ms(lambda: FK.scalar_round_step(vals6, w6, carry), 20),
           median_ms(lambda: ref.scalar_round_step(vals6, w6, carry), 3),
           4 * (2 * N + 2 * carry.numel()), 6 * N,
           median_ms(lambda: torch.sum(x, dim=-1), 20),
           {"with_closures_ms": f"{median_ms(lambda: FK.fused_round_step(q6, st6, sl), 10):.6f}",
            "pr16_ms": PR16_MS["fused_round_step/scalar"],
            "library_device_ms": device_ms(lambda: torch.sum(x, dim=-1)),
            **phases(lambda: FK.scalar_round_step(vals6, w6, carry), scalar_split)})
    del x

    # K1 group on one round-slice, both group shapes of the main path, the
    # one-group table and Q15's round-slice at SF 100
    for label in ("G=4", "G=8192", "G=1", "Q15"):
        gla, vals, w, gids, cs, cq, cm = group_inputs[label]
        G = cm.shape[-1]
        N = w.numel()
        src = stacked(vals, w)
        idx = (gids.long() + torch.arange(P, device=dev)[:, None, None] * G).reshape(-1)
        acc = torch.zeros((P * G, src.shape[1]), device=dev)
        ms = median_ms(lambda: FK.group_round_step(vals, w, gids, cs, cq, cm), 10)
        plain = median_ms(lambda: ref.group_round_step(vals, w, gids, cs, cq, cm), 3)
        lib = median_ms(lambda: acc.index_add_(0, idx, src), 10)
        withc = None  # G=1 and Q15: no GLA of this run has the table, kernel alone
        if label in ("G=4", "G=8192"):
            st = scan.stack_init(gla, (P,), dev)
            withc = f"{median_ms(lambda: FK.fused_round_step(gla, st, sl), 5):.6f}"
        nbytes = 4 * (vals.numel() + 2 * N + 2 * (cs.numel() + cq.numel() + cm.numel()))
        pr14 = PR14_MS.get(f"fused_round_step/group[{label}]")
        nt = tiles(w.shape[1], [(vals.shape[-1], G)])
        ph = {"tiles": nt, **phases(lambda: FK.group_round_step(vals, w, gids, cs, cq, cm),
                                    group_split(nt))}
        if label == "G=8192":
            record("fused_round_step/group", K1, ms, plain, nbytes, 17 * N, lib,
                   {"shape": label, "with_closures_ms": withc, "pr14_ms": pr14, **ph})
        else:
            b, by = bound(nbytes, 17 * N)
            say("time", kernel=f"fused_round_step/group[{label}]", ms=f"{ms:.6f}",
                plain_ms=f"{plain:.6f}", bound_ms=f"{b:.6f}", bound_by=by,
                library_ms=lib, with_closures_ms=withc, pr14_ms=pr14,
                span=ops.group_step_span(L, vals.shape[-1], G), **ph)
        del src, idx, acc
    del group_inputs["Q15"], vals, w, gids, cs, cq, cm

    # K2 on the whole shard
    N = valsK2.numel()
    x = stacked_rows_last(valsK2, wK2)
    record("fused_prefix_states", K2,
           median_ms(lambda: FK.scalar_prefix(valsK2, wK2), 10),
           median_ms(lambda: ref.scalar_prefix(valsK2, wK2), 3),
           4 * (2 * N + P * C * 3), 6 * N,
           median_ms(lambda: torch.cumsum(x, dim=-1), 5),
           {"with_closures_ms": f"{median_ms(lambda: FK.fused_prefix_states(q6, shards), 5):.6f}",
            "pr16_ms": PR16_MS["fused_prefix_states"],
            "library_device_ms": device_ms(lambda: torch.cumsum(x, dim=-1)),
            **phases(lambda: FK.scalar_prefix(valsK2, wK2), scalar_split)})
    del x

    # K4 on the whole shard
    N = vK4.numel()
    wm = wK4 * mK4
    x = torch.stack([vK4 * wm, (vK4 * vK4) * wm, mK4, wm], dim=2)  # [P, C, 4, L]
    del wm
    record("shard_chunk_partials", K4,
           median_ms(lambda: ops.shard_chunk_partials(vK4, wK4, mK4), 10),
           median_ms(lambda: ref.shard_chunk_partials(vK4, wK4, mK4), 3),
           4 * (3 * N + 4 * P * C), 8 * N,
           median_ms(lambda: torch.sum(x, dim=-1), 10),
           {"with_closures_ms":
            f"{median_ms(lambda: scan.kernel_prefix_states(q6k, shards), 5):.6f}"})
    del x

    def index_add_call(vals, w, gids, G):
        """The library call for a group table: ``index_add_`` of the
        stacked products (v·w, v·v·w, w) into [P·G, 2A+1]."""
        src = stacked(vals, w)
        idx = (gids.long() + torch.arange(P, device=dev).reshape(
            P, *([1] * (gids.ndim - 1))) * G).reshape(-1)
        acc = torch.zeros((P * G, src.shape[1]), device=dev)
        return lambda: acc.index_add_(0, idx, src)

    # K3 on one round-slice: Q3 alone (the JSON row) and the [Q6, Q1-small,
    # Q3] bundle in one pf_group_agg_bundle launch
    for label, gla, reps in (("Q3", q3, 5), ("stack", b3, 3)):
        members = k3_inputs[label] if gla.members else [k3_inputs[label]]
        N = members[0][1].numel()
        shapes = [(m[0].shape[-1], m[3]) for m in members]
        libs = [index_add_call(*m) for m in members]
        nt = tiles(N // P // L, shapes)
        run = (lambda: ops.group_agg_bundle(members, block_rows=L)) if gla.members else (
            lambda: ops.group_agg(*members[0][:3], num_groups=members[0][3], block_rows=L))
        withc = (lambda: scan.bundle_round_deltas(gla, sl)) if gla.members else (
            lambda: scan.kernel_round_delta(gla, sl))
        args = (label, K3, median_ms(run, reps),
                median_ms(lambda: [ref.group_agg(*m, L) for m in members], 2),
                sum(4 * (m[0].numel() + 2 * N + P * G * (2 * A + 1))
                    for m, (A, G) in zip(members, shapes)),
                sum((4 * A + 1) * N for A, _ in shapes),
                median_ms(lambda: [f() for f in libs], 5),
                {"with_closures_ms": f"{median_ms(withc, 2):.6f}",
                 "groups": [G for _, G in shapes], "pr14_ms": PR14_MS[f"group_agg[{label}]"],
                 "tiles": nt, **phases(run, group_split(nt))})
        del libs
        if label == "Q3":
            record("group_agg", *args[1:])
        else:
            b, by = bound(args[4], args[5])
            say("time", kernel="group_agg[stack]", ms=f"{args[2]:.6f}",
                plain_ms=f"{args[3]:.6f}", bound_ms=f"{b:.6f}", bound_by=by,
                library_ms=args[6], bytes=args[4], flops=args[5], **args[7])

    # olabench's sf100-report-join bundle at its round-slice, the operands of
    # the check above made again from the same seed; the library yardstick is
    # one index_add_ a member, each timed alone, summed
    jb = join_bundle(dev, Q15_CHUNKS, SEED + 35)
    N = jb[0][1].numel()
    shapes = [(m[0].shape[-1], m[3]) for m in jb]
    nbytes = sum(4 * (m[0].numel() + 2 * N + P * G * (2 * A + 1))
                 for m, (A, G) in zip(jb, shapes))
    flops = sum((4 * A + 1) * N for A, _ in shapes)
    lib_ms = sum(median_ms(index_add_call(*m), 5) for m in jb)
    nt = tiles(N // P // L, shapes)
    b, by = bound(nbytes, flops)
    say("time", kernel="group_agg_bundle[report-join-sf100]",
        ms=f"{median_ms(lambda: ops.group_agg_bundle(jb, block_rows=L), 5):.6f}",
        plain_ms=f"{median_ms(lambda: [ref.group_agg(*m, L) for m in jb], 2):.6f}",
        bound_ms=f"{b:.6f}", bound_by=by, library_ms=lib_ms, bytes=nbytes, flops=flops,
        groups=[G for _, G in shapes], tiles=nt,
        fold_visits=ops.group_step_visits(P, N // P // L, L, shapes),
        **phases(lambda: ops.group_agg_bundle(jb, block_rows=L), group_split(nt)))
    del jb

    def bundle_cost(margs):
        """A K1 bundle's bytes and operations (the sum of its members'), its
        library yardstick (a sum or an ``index_add_`` per member, summed),
        and its group step's tiles and grid split."""
        nbytes = flops = 0
        lib_ms = 0.0
        for m in margs:
            N, A = m[1].numel(), m[0].shape[-1]
            carries = m[3:] if m[2] is not None else m[3:4]
            nbytes += 4 * (m[0].numel() + N * (1 if m[2] is None else 2)
                           + 2 * sum(c.numel() for c in carries))
            flops += (4 * A + 1 + (m[2] is None)) * N
            if m[2] is None:
                x = stacked_rows_last(m[0], m[1])
                lib_ms += median_ms(lambda: torch.sum(x, dim=-1), 10)
            else:
                lib_ms += median_ms(index_add_call(m[0], m[1], m[2], m[5].shape[-1]), 5)
            x = None
        nt = tiles(margs[0][1].shape[1],
                   [(m[0].shape[-1], m[5].shape[-1]) for m in margs if m[2] is not None])
        split = {**group_split(nt), "scalar_partials_ms": ("bundle_partials", 1),
                 "scalar_fold_ms": ("bundle_fold", 1)}
        return nbytes, flops, lib_ms, {"members": len(margs), "tiles": nt,
                                       **phases(lambda: FK.bundle_round_step(margs), split)}

    # K1 bundle on one round-slice: [Q6, Q1-small, Q1-large, supplier ⋈ nation]
    nbytes, flops, lib_ms, ph = bundle_cost(bundle_args)
    stb = scan.stack_init(bf, (P,), dev)
    record("fused_round_step/bundle", K1,
           median_ms(lambda: FK.bundle_round_step(bundle_args), 10),
           median_ms(lambda: ref.bundle_round_step(bundle_args), 2),
           nbytes, flops, lib_ms,
           {**ph, "pr14_ms": PR14_MS["fused_round_step/bundle"],
            "pr16_ms": PR16_MS["fused_round_step/bundle"],
            "with_closures_ms": f"{median_ms(lambda: FK.fused_round_step(bf, stb, sl), 5):.6f}"})
    # olabench's report bundle [Q6, Q1, Q15] at both cells' round-slices, the
    # operands of the check above made again from the same seed
    for label, (chunks, suppliers) in REPORT_SLICES.items():
        margs = report_bundle(dev, chunks, suppliers, SEED + 15)
        nbytes, flops, lib_ms, ph = bundle_cost(margs)
        b, by = bound(nbytes, flops)
        say("time", kernel=f"fused_round_step/bundle[report-{label}]",
            ms=f"{median_ms(lambda: FK.bundle_round_step(margs), 10):.6f}",
            plain_ms=f"{median_ms(lambda: ref.bundle_round_step(margs), 2):.6f}",
            bound_ms=f"{b:.6f}", bound_by=by, library_ms=lib_ms, bytes=nbytes,
            flops=flops, groups=[4, suppliers], **ph)
        del margs

    # K1's decode stage on one encoded round-slice (all five encoded columns,
    # one launch); the library yardstick is one indexing or shift-and-mask
    # call per column, summed
    outs = KD.decode(dec_in)
    nbytes = sum(x.numel() * x.element_size() for x, _ in dec_in) + sum(
        y.numel() * y.element_size() for y in outs)
    lib_calls = []
    for x, e in dec_in:
        if isinstance(e, ENC.DictEncoding):
            tab, idx = e.table(dev), x.long()
            lib_calls.append(lambda tab=tab, idx=idx: torch.take(tab, idx))
        else:
            sh = e.bits * torch.arange(e.lanes, dtype=torch.int32, device=dev)
            lib_calls.append(lambda x=x, sh=sh, m=(1 << e.bits) - 1: (x[..., None] >> sh) & m)
    lib_ms = sum(median_ms(f, 20) for f in lib_calls)
    record("decode", DECODE, median_ms(lambda: KD.decode(dec_in), 20),
           median_ms(plain_decode, 5), nbytes, 0, lib_ms,
           {"columns": len(dec_in), "rows": phys["_mask"].numel(),
            "with_closures_ms": f"{median_ms(lambda: FK.fused_round_step(q6, st6, phys, enc_src.encodings), 10):.6f}",
            "pr16_ms": PR16_MS["decode"],
            "library_device_ms": device_ms(lambda: [f() for f in lib_calls]),
            **phases(lambda: KD.decode(dec_in), {"decode_ms": ("decode_kernel", 1)})})
    del outs

    # K5 and K6 on the whole shard flattened (234,881,024 rows); the library
    # yardstick is torch.sum over the four stacked products
    v5, w5, m5 = q6.fused.func(flat), q6.fused.cond(flat), flat["_mask"]
    wm = w5 * m5
    x = torch.stack([v5 * wm, (v5 * v5) * wm, m5, wm])
    del wm
    lib_ms = median_ms(lambda: torch.sum(x, dim=1), 10)
    del x
    record("chunk_agg", K5, median_ms(lambda: ops.chunk_agg(v5, w5, m5), 10),
           median_ms(lambda: ref.chunk_agg(v5, w5, m5), 3), 12 * ROWS + 16, 8 * ROWS,
           lib_ms, {"rows": ROWS, "with_closures_ms": f"{median_ms(lambda: ops.chunk_agg(q6.fused.func(flat), q6.fused.cond(flat), m5), 5):.6f}"})
    del v5, w5
    record("q6_agg", K6, median_ms(lambda: ops.q6_agg(q6_params, *q6_cols(flat)), 10),
           median_ms(lambda: ref.q6_agg(q6_params, *q6_cols(flat)), 3),
           20 * ROWS + 20 + 16, 15 * ROWS, lib_ms, {"rows": ROWS, "raw_columns": True})

    say("end-to-end", **{k.replace(" ", "_"): f"{v:.3f}s" for k, v in e2e.items()})
    for r_ in rows:
        check(all(math.isfinite(r_[k]) for k in ("ms", "plain_ms", "bound_ms")),
              f"{r_['name']}: non-finite timing")
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
