"""The port's contract linter (``repro_torch.contracts``): each rule fires on
crafted violations and stays quiet on the idioms the port uses, the tree
lints clean (under the port's rules and under the reference's), and the
CLI's exit codes.  Fixtures are strings written under ``tmp_path``, never
code of this file: the reference's linter reads ``tests/`` too."""
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import contracts as REF
from repro_torch import contracts as K
from repro_torch import spec as TSPEC

REPO = Path(__file__).resolve().parents[1]


def _lint(tmp_path, relpath, src):
    p = tmp_path / relpath
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(src)
    return K.lint_file(p, tmp_path)


def _codes(vs):
    return sorted(v.code for v in vs)


# -- C001/C002/C010: carried over -----------------------------------------------

def test_c001_and_c002_carry_over(tmp_path):
    vs = _lint(tmp_path, "q.py", (
        "from repro_torch.gla import GLA\n"
        "bad = GLA(name='x', kernel_num_groups=8)\n"
        "good = GLA(name='y', kernel_num_groups=8, kernel_cols=('a',))\n"
        "class Half(GLA):\n"
        "    def serialize(self):\n"
        "        return b''\n"
        "class Full(GLA):\n"
        "    kernel_cols = ('a',)\n"
        "    kernel_num_groups = 4\n"))
    assert sorted((v.code, v.line) for v in vs) == [("C001", 2), ("C002", 4)]


def test_c010_plan_nodes_declare_monoid_and_estimator(tmp_path):
    vs = _lint(tmp_path, "repro_torch/spec.py", (
        "class PlanNode:\n"
        "    monoid = None\n"
        "class Scan(PlanNode):\n"
        "    monoid = 'sum'\n"
        "    estimator = 'ht'\n"
        "class Filter(Scan):\n"
        "    monoid = 'sum'\n"))
    assert _codes(vs) == ["C010"] and "Filter" in vs[0].message


# -- C003: host syncs in the registered hot-step functions ---------------------

_SYNCS = (
    "import numpy as np\n"
    "import torch\n"
    "def round_step(gla, states, cols):\n"
    "    n = float(states.sum())\n"
    "    k = states.item()\n"
    "    h = np.asarray(states)\n"
    "    c = states.cpu()\n"
    "    torch.cuda.synchronize()\n"
    "    def inner(x):\n"
    "        return x.tolist()\n"
    "    return inner(states), n, k, h, c\n"
    "def scan_round_step(gla, states, cols):\n"
    "    return states.item()\n")


def test_c003_fires_in_registered_functions_only(tmp_path):
    vs = _lint(tmp_path, "repro_torch/scan.py", _SYNCS)
    assert _codes(vs) == ["C003"] * 6
    assert {v.line for v in vs} == {4, 5, 6, 7, 8, 10}      # not scan_round_step's
    assert _lint(tmp_path, "repro_torch/engine.py", _SYNCS) == []


def test_c003_casts_only_what_can_be_a_tensor(tmp_path):
    """A cast of a value that is statically the host's (a tensor's sizes, a
    module constant, len(), a local bound only to such) is no sync."""
    src = ("LIMIT = 4096\n"
           "def round_step(gla, states, cols):\n"
           "    n = states.numel() * states.element_size()\n"
           "    a = int(n <= LIMIT)\n"
           "    b = bool(len(cols) > 0)\n"
           "    c = float(states.shape[0] / 2)\n"
           "    m = n\n"
           "    m += states.sum()\n"
           "    d = int(m)\n"
           "    e = bool(gla.members)\n"
           "    f = float(states.sum() / n)\n"
           "    return a, b, c, d, e, f\n")
    vs = _lint(tmp_path, "repro_torch/scan.py", src)
    assert _codes(vs) == ["C003"] * 3
    assert [v.line for v in vs] == [9, 10, 11]


def test_c003_names_methods(tmp_path):
    src = ("class Transformer:\n"
           "    def decode_step(self, token, cache, pos):\n"
           "        return token.tolist()\n"
           "    def example_nll(self, tokens):\n"
           "        return tokens.tolist()\n")
    vs = _lint(tmp_path, "repro_torch/models/transformer.py", src)
    assert _codes(vs) == ["C003"] and vs[0].line == 3


# -- C004: no global RNG in the port ---------------------------------------------

_RNG = (
    "import random\n"
    "import numpy as np\n"
    "import torch\n"
    "def draw(g, t):\n"
    "    torch.manual_seed(0)\n"
    "    a = torch.randn(3)\n"
    "    b = torch.randn(3, generator=g)\n"
    "    c = torch.randperm(5)\n"
    "    t.normal_()\n"
    "    t.uniform_(generator=g)\n"
    "    d = np.random.normal()\n"
    "    e = np.random.default_rng(0).normal()\n"
    "    f = random.random()\n"
    "    h = torch.Generator().manual_seed(3)\n"
    "    return a, b, c, d, e, f, h\n")


def test_c004_global_draws_fire_in_the_port_only(tmp_path):
    vs = _lint(tmp_path, "src/repro_torch/x.py", _RNG)
    assert _codes(vs) == ["C004"] * 6
    assert {v.line for v in vs} == {5, 6, 8, 9, 11, 13}
    assert _lint(tmp_path, "tests/test_x.py", _RNG) == []
    assert _lint(tmp_path, "tools/x.py", _RNG) == []


# -- C005/C006: estimator clamps -------------------------------------------------

def test_c005_unclamped_vs_clamped_division(tmp_path):
    vs = _lint(tmp_path, "repro_torch/estimators.py", (
        "import torch\n"
        "def variance_estimate(s, sq, n, d):\n"
        "    safe = torch.clamp(n, min=2.0)\n"
        "    den = safe * safe * (safe - 1.0)\n"
        "    est = d / den\n"
        "    frac = s / 2.0\n"
        "    top = s / max(float(d), 1.0)\n"
        "    m = s / n.clamp_min(1.0)\n"
        "    bad = s / n\n"
        "    return torch.where(n >= 2.0, est + frac + top + m + bad, torch.inf)\n"))
    assert _codes(vs) == ["C005"] and vs[0].line == 9


def test_c006_variance_guards_must_survive(tmp_path):
    vs = _lint(tmp_path, "repro_torch/estimators.py", (
        "def variance_estimate(s, sq, n, d):\n"
        "    return d / 2.0\n"))
    assert _codes(vs) == ["C006", "C006"]
    assert _codes(_lint(tmp_path, "repro_torch/estimators.py", "x = 1\n")) == ["C006"]


# -- C007: the port's envelope manifest ----------------------------------------------

def _session(version, keys):
    entries = ", ".join(f"'{k}': 0" for k in keys)
    return (f"_CKPT_VERSION = {version}\n"
            "class Session:\n"
            "    def _meta(self):\n"
            f"        return {{{entries}}}\n")


def test_c007_manifest(tmp_path):
    v = max(K.ENVELOPE_HISTORY)
    keys = sorted(K.ENVELOPE_HISTORY[v])
    assert "framework" in keys and v == 3
    assert _lint(tmp_path, "repro_torch/session.py", _session(v, keys)) == []
    drift = _lint(tmp_path, "repro_torch/session.py", _session(v, keys + ["surprise"]))
    assert _codes(drift) == ["C007"] and "surprise" in drift[0].message
    stale = _lint(tmp_path, "repro_torch/session.py", _session(v - 1, keys))
    assert _codes(stale) == ["C007"] and "bump" in stale[0].message
    # the reference's manifest lacks the port's "framework" key
    assert K.ENVELOPE_HISTORY[3] == REF.ENVELOPE_HISTORY[3] | {"framework"}


# -- C008: suppressions -------------------------------------------------------------

def test_c008_suppressions(tmp_path):
    vs = _lint(tmp_path, "q.py", (
        "from repro_torch.gla import GLA\n"
        "q = GLA(name='x', kernel_num_groups=8)  # torch-contracts: allow(C001)\n"))
    assert _codes(vs) == ["C008"] and "ALLOWLIST" in vs[0].message
    stale = _lint(tmp_path, "q.py", "x = 1  # torch-contracts: allow(C001)\n")
    assert _codes(stale) == ["C008"] and "stale" in stale[0].message
    ok = _lint(tmp_path, "repro_torch/models/transformer.py", (
        "class Transformer:\n"
        "    def decode_step(self, token, cache, pos):\n"
        "        pos = int(pos)  # torch-contracts: allow(C003)\n"))
    assert ok == []
    # the reference's marker means nothing to this linter, and the reverse
    ref_marker = _lint(tmp_path, "q.py", "x = 1  # contracts: allow(C001)\n")
    assert ref_marker == []


def test_the_allowlisted_casts_are_of_host_values():
    """The port's two C003 suppressions, each a cast of a host value the
    linter cannot type: decode_step's int(pos) and fused_round_step's
    bool(gla.members)."""
    marked = {f: [line for line in (REPO / "src" / f).read_text().splitlines()
                  if "torch-contracts: allow" in line]
              for f in ("repro_torch/models/transformer.py", "repro_torch/kernels/fused_agg.py")}
    assert marked == {
        "repro_torch/models/transformer.py": ["        pos = int(pos)  # torch-contracts: allow(C003)"],
        "repro_torch/kernels/fused_agg.py": [
            "    is_bundle = bool(gla.members)  # torch-contracts: allow(C003)"]}
    assert sorted(K.ALLOWLIST) == [("repro_torch/kernels/fused_agg.py", "C003"),
                                   ("repro_torch/models/transformer.py", "C003")]


# -- C009: the literal copy of the deprecated kwargs -----------------------------------

def test_c009_copy_equals_the_spec_and_fires_outside_tests(tmp_path):
    assert K.DEPRECATED_PLAN_KWARGS == frozenset(TSPEC.DEPRECATED_PLAN_KWARGS)
    src = ("import repro_torch as T\n"
           "T.run_query(q, shards, rounds=4)\n"
           "T.Session(q, shards, plan=p)\n")
    assert _codes(_lint(tmp_path, "src/repro_torch/x.py", src)) == ["C009"]
    assert _lint(tmp_path, "tests/test_x.py", src) == []


# -- the tree --------------------------------------------------------------------------

@pytest.mark.parametrize("target", ["src/repro_torch", "tests", "chip_smoke.py"])
def test_the_port_lints_clean(target):
    vs = [v for f in K.iter_py_files([target], REPO) for v in K.lint_file(f, REPO)]
    assert not vs, "\n".join(map(str, vs))


def test_the_port_lints_clean_under_the_reference_rules():
    vs = [v for f in REF.iter_py_files(["src/repro_torch"], REPO) for v in REF.lint_file(f, REPO)]
    assert not vs, "\n".join(map(str, vs))


def test_cli_exit_codes(tmp_path):
    (tmp_path / "ok.py").write_text("x = 1\n")
    bad = tmp_path / "bad.py"
    bad.write_text("from repro_torch.gla import GLA\nq = GLA(name='x', kernel_num_groups=8)\n")
    assert K.main([str(tmp_path / "ok.py")]) == 0
    r = subprocess.run([sys.executable, "-m", "repro_torch.contracts", str(bad)],
                       capture_output=True, text=True, cwd=str(REPO),
                       env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 1 and "C001" in r.stdout and "FAIL" in r.stdout
    r = subprocess.run([sys.executable, "-m", "repro_torch.contracts"], capture_output=True,
                       text=True, cwd=str(REPO), env={"PYTHONPATH": str(REPO / "src")})
    assert r.returncode == 0 and "contracts: OK — 0 violation(s)" in r.stdout, r.stdout[-2000:]
