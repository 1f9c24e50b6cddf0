"""Framework-contract linter for the PyTorch port — static AST checks on the
port's own source, with the stdlib ``ast`` module only (no torch import):

    python -m repro_torch.contracts [targets]   # default: src/repro_torch tests chip_smoke.py

Port of ``repro/analysis/contracts.py``: the same output format (one
``path:line: CODE message`` line a violation, then a summary line) and exit
codes (0 clean, 1 with violations).  Each of the reference's rules and what
it became:

  C001  carried over: ``GLA(...)`` with ``kernel_num_groups`` must also pass
        ``kernel_cols`` (the port's ``GLA`` keeps the pairing).
  C002  carried over: a ``GLA`` subclass overrides both or neither of
        (``kernel_cols``, ``kernel_num_groups``) and (``serialize``,
        ``deserialize``).
  C003  no host sync inside the registered hot-step functions
        (:data:`HOT_STEP_FUNCTIONS`: the kernel wrappers' launch path,
        ``scan.round_step``'s kernel routes, the decode step).  A sync is
        ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
        ``float()``/``int()``/``bool()`` of anything that can be a tensor
        (not of a value that is statically the host's: a constant, a
        module constant in capitals, a tensor's ``numel()``/``shape``/
        ``element_size()`` and the like, ``len()``, arithmetic and
        comparisons of these, a local name bound only to them),
        ``np.asarray``/``np.array``, or
        ``torch.cuda.synchronize()``.  Each stalls the host on the card.
        The reference's registry names jitted files; this one names
        functions (``"Class.method"`` for a method), nested defs included.
  C004  no global RNG anywhere in ``src/repro_torch``: no
        ``torch.manual_seed`` (or ``torch.cuda.manual_seed*``,
        ``torch.seed``), no ``torch.rand*``/``randn*``/``randint*``/
        ``randperm``/``normal``/``bernoulli``/``multinomial``/``poisson``
        and no ``.normal_()``/``.uniform_()``/``.bernoulli_()``/
        ``.random_()``/``.exponential_()``/``.multinomial()`` without
        ``generator=``, no ``np.random.<fn>`` but ``default_rng`` and
        ``Generator``, and no stdlib ``random``.  The port's rule is
        explicit generators.  The reference's wall-clock half (a clock read
        frozen into a trace) is JAX-only: eager code has no trace time.
  C005  divisions in ``repro_torch/estimators.py`` have statically clamped
        denominators: a nonzero constant, a value built from
        ``torch.clamp``/``torch.maximum``/``clamp_min`` (or the methods
        ``.clamp``/``.clamp_min``), or Python's ``max`` with a positive
        constant — the "no NaN reaches a QueryResult" invariant.
  C006  ``variance_estimate`` keeps both guards: a clamp (``torch.clamp``,
        ``torch.maximum`` or ``clamp_min``) and the ``torch.where``
        small-sample gate.
  C007  ``repro_torch/session.py``'s ``_CKPT_VERSION`` equals the newest
        version in the port's :data:`ENVELOPE_HISTORY`, and the keys
        ``Session._meta`` returns equal that manifest (the port's envelope
        has ``framework``).
  C008  carried over: suppressions (``# torch-contracts: allow(C0XX)``) are
        honored only for ``(path-suffix, rule)`` pairs in :data:`ALLOWLIST`,
        each with its reason; an unlisted or stale suppression is an error.
        The marker differs from the reference's, whose linter also reads
        the port's files.
  C009  ``run_query``/``run_queries``/``Session`` calls outside ``tests/``
        pass none of :data:`DEPRECATED_PLAN_KWARGS`, a literal copy of
        ``repro_torch.spec.DEPRECATED_PLAN_KWARGS`` (a test holds the two
        equal).
  C010  carried over: every ``PlanNode`` subclass (``repro_torch/spec.py``)
        declares ``monoid`` and ``estimator``.
"""
from __future__ import annotations

import argparse
import ast
import io
import re
import sys
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

# ---------------------------------------------------------------------------
# Policy tables
# ---------------------------------------------------------------------------

#: functions on the step's hot path, by file (path suffix): no host sync
HOT_STEP_FUNCTIONS: Dict[str, tuple] = {
    "repro_torch/kernels/fused_agg.py": (
        "_scalar", "scalar_round_step", "scalar_prefix", "group_round_step",
        "bundle_round_step", "_bundle_launch", "fused_round_step", "fused_prefix_states"),
    "repro_torch/kernels/ops.py": ("group_agg", "shard_chunk_partials", "chunk_agg", "q6_agg"),
    "repro_torch/kernels/decode.py": ("decode", "_launch"),
    "repro_torch/kernels/_runtime.py": ("launch", "check", "route", "ptr"),
    "repro_torch/scan.py": ("round_step",),
    "repro_torch/models/transformer.py": (
        "Transformer.decode_step", "Transformer._block_decode", "Transformer._attn_decode"),
}

# The deprecated loose plan kwargs (C009): repro_torch.spec's, copied
# literally so that the linter runs without importing the package
# (tests/test_torch_contracts.py holds the two equal).
DEPRECATED_PLAN_KWARGS: frozenset = frozenset({
    "rounds", "schedule", "stop", "confidence", "mode", "emit", "lanes",
    "snapshots", "alive", "fault", "estimator_merge", "sync_cost_model",
})

_PLAN_ENTRY_POINTS = frozenset({"run_query", "run_queries", "Session"})

# The port's checkpoint envelope manifest (C007).  Changing Session._meta's
# keys requires a _CKPT_VERSION bump and a new entry here.  Append-only.
ENVELOPE_HISTORY: Dict[int, frozenset] = {
    3: frozenset({
        "version", "framework", "gla", "rounds", "steps", "emit", "mode", "lanes",
        "snapshots", "confidence", "path", "P", "C", "L", "schedule",
        "alive", "cursors", "fail_at", "fault_estimator", "elapsed_s",
        "converged", "source", "fingerprint",
    }),
}

# The only suppressions honored: (path suffix, rule) -> why the path needs it.
ALLOWLIST: Dict[tuple, str] = {
    ("repro_torch/models/transformer.py", "C003"):
        "decode_step's int(pos): every caller passes the position as a host int "
        "(greedy_generate, the serving loops, the tests); int() normalizes a numpy "
        "or host integer and would sync only on a card tensor, which none passes",
    ("repro_torch/kernels/fused_agg.py", "C003"):
        "fused_round_step's bool(gla.members): the GLA's tuple of bundle members, "
        "a host value the linter cannot type",
}

_SUPPRESS_RE = re.compile(r"#\s*torch-contracts:\s*allow\((C\d{3})\)")

_HOST_CASTS = {"float", "int", "bool"}
#: what is the host's whatever it is called on or of (C003)
_HOST_FNS = {"len", "isinstance", "hasattr", "callable", "id"}
_HOST_QUERIES = {"numel", "element_size", "dim", "size", "stride", "data_ptr", "nbytes",
                 "is_contiguous", "get_device"}
_HOST_ATTRS = {"ndim", "shape", "is_cuda", "dtype", "device", "itemsize"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_TORCH_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
                "randperm", "normal", "bernoulli", "multinomial", "poisson"}
_METHOD_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_", "exponential_",
                 "geometric_", "log_normal_", "cauchy_", "multinomial"}
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                 "torch.random.seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                 "torch.cuda.seed", "torch.cuda.seed_all"}
_NP_RANDOM_OK = {"default_rng", "Generator"}


class Violation:
    __slots__ = ("path", "line", "code", "message")

    def __init__(self, path: str, line: int, code: str, message: str):
        self.path, self.line = path, line
        self.code, self.message = code, message

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


def _dotted(node: ast.AST) -> str:
    """'np.random.normal' for nested Attribute/Name chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _posix(rel: str) -> str:
    return rel.replace("\\", "/")


# ---------------------------------------------------------------------------
# C001/C002 — GLA construction and subclass pairing
# ---------------------------------------------------------------------------

_PAIRS = (("kernel_cols", "kernel_num_groups"), ("serialize", "deserialize"))


def _class_names(node: ast.ClassDef) -> Set[str]:
    defined: Set[str] = set()
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defined.add(item.name)
        elif isinstance(item, ast.Assign):
            defined.update(t.id for t in item.targets if isinstance(t, ast.Name))
        elif isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
            defined.add(item.target.id)
    return defined


def _check_gla(tree: ast.Module, path: str, out: List[Violation]) -> None:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _dotted(node.func).split(".")[-1] == "GLA":
            kw = {k.arg for k in node.keywords if k.arg}
            if "kernel_num_groups" in kw and "kernel_cols" not in kw:
                out.append(Violation(
                    path, node.lineno, "C001",
                    "GLA(..., kernel_num_groups=...) without kernel_cols=: "
                    "the group kernel has no input columns to gather"))
        if isinstance(node, ast.ClassDef):
            if "GLA" not in {_dotted(b).split(".")[-1] for b in node.bases}:
                continue
            defined = _class_names(node)
            for a, b in _PAIRS:
                if (a in defined) != (b in defined):
                    have, miss = (a, b) if a in defined else (b, a)
                    out.append(Violation(
                        path, node.lineno, "C002",
                        f"GLA subclass {node.name} defines {have} without "
                        f"{miss}: the protocol is both-or-neither"))


# ---------------------------------------------------------------------------
# C003 — host syncs inside the registered hot-step functions
# ---------------------------------------------------------------------------

def _functions(tree: ast.Module) -> Dict[str, ast.AST]:
    """Qualified name ('f' or 'Class.f') -> def, for top-level functions and
    methods of top-level classes."""
    out: Dict[str, ast.AST] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{item.name}"] = item
    return out


def _host_value(e: ast.AST, names: Set[str]) -> bool:
    """Whether ``e`` is statically a host value (never a tensor): see C003."""
    if isinstance(e, ast.Constant):
        return True
    if isinstance(e, ast.Name):
        return e.id in names or (e.id.isupper() and len(e.id) > 1)
    if isinstance(e, ast.Attribute):
        return e.attr in _HOST_ATTRS
    if isinstance(e, ast.Subscript):
        return _host_value(e.value, names)
    if isinstance(e, ast.Call):
        f = e.func
        return ((isinstance(f, ast.Name) and f.id in _HOST_FNS)
                or (isinstance(f, ast.Attribute) and f.attr in _HOST_QUERIES))
    if isinstance(e, ast.Compare):
        return all(_host_value(x, names) for x in [e.left, *e.comparators])
    if isinstance(e, ast.BoolOp):
        return all(_host_value(x, names) for x in e.values)
    if isinstance(e, ast.BinOp):
        return _host_value(e.left, names) and _host_value(e.right, names)
    if isinstance(e, ast.UnaryOp):
        return _host_value(e.operand, names)
    if isinstance(e, (ast.Tuple, ast.List)):
        return all(_host_value(x, names) for x in e.elts)
    return False


def _host_names(fn: ast.AST) -> Set[str]:
    """The local names of ``fn`` whose every binding is a host value (a
    plain ``name = value`` assignment each)."""
    values: Dict[str, list] = {}
    other: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
                node.targets[0], ast.Name):
            values.setdefault(node.targets[0].id, []).append(node.value)
            continue
        if isinstance(node, ast.Assign):
            bound = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For, ast.AsyncFor,
                               ast.comprehension, ast.NamedExpr)):
            bound = [node.target]
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            bound = [i.optional_vars for i in node.items if i.optional_vars is not None]
        elif isinstance(node, ast.arguments):
            other.update(a.arg for a in [*node.posonlyargs, *node.args, *node.kwonlyargs])
            continue
        else:
            continue
        for t in bound:
            other.update(n.id for n in ast.walk(t) if isinstance(n, ast.Name))
    names: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for k, vs in values.items():
            if k not in names and k not in other and all(_host_value(v, names) for v in vs):
                names.add(k)
                changed = True
    return names


def _check_syncs(fn: ast.AST, qual: str, path: str, out: List[Violation]) -> None:
    where = f"in hot-step function {qual!r}"
    host = _host_names(fn)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        if isinstance(node.func, ast.Name) and node.func.id in _HOST_CASTS:
            if len(node.args) == 1 and _host_value(node.args[0], host):
                continue
            out.append(Violation(
                path, node.lineno, "C003",
                f"host conversion {node.func.id}(...) {where}: of a card tensor it "
                "stalls the host until the card catches up"))
        elif d in ("np.asarray", "np.array", "numpy.asarray", "numpy.array"):
            out.append(Violation(path, node.lineno, "C003", f"host copy {d}(...) {where}"))
        elif d in ("torch.cuda.synchronize", "cuda.synchronize"):
            out.append(Violation(path, node.lineno, "C003", f"{d}() {where}"))
        elif isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS and not (
                d.startswith(("np.", "numpy.", "torch."))):
            out.append(Violation(
                path, node.lineno, "C003", f"host sync .{node.func.attr}() {where}"))


# ---------------------------------------------------------------------------
# C004 — global RNG in the port
# ---------------------------------------------------------------------------

def _has_generator(node: ast.Call) -> bool:
    return any(k.arg == "generator" for k in node.keywords)


def _check_rng(tree: ast.Module, path: str, out: List[Violation]) -> None:
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "random":
            out.append(Violation(path, node.lineno, "C004",
                                 "stdlib random imported: draw from an explicit generator"))
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        leaf = d.split(".")[-1] if d else (
            node.func.attr if isinstance(node.func, ast.Attribute) else "")
        if d in _GLOBAL_SEEDS:
            out.append(Violation(
                path, node.lineno, "C004",
                f"{d}(...) seeds the global generator: pass an explicit "
                "torch.Generator instead"))
        elif d.startswith("torch.") and d.count(".") == 1 and leaf in _TORCH_DRAWS and (
                not _has_generator(node)):
            out.append(Violation(
                path, node.lineno, "C004",
                f"{d}(...) without generator=: draws from the global generator"))
        elif isinstance(node.func, ast.Attribute) and leaf in _METHOD_DRAWS and not (
                d.startswith(("np.", "numpy."))) and not _has_generator(node):
            out.append(Violation(
                path, node.lineno, "C004",
                f".{leaf}(...) without generator=: draws from the global generator"))
        elif d.startswith(("np.random.", "numpy.random.")) and leaf not in _NP_RANDOM_OK:
            out.append(Violation(
                path, node.lineno, "C004",
                f"{d}(...): numpy's global generator — use np.random.default_rng(seed)"))
        elif d.startswith("random."):
            out.append(Violation(
                path, node.lineno, "C004", f"{d}(...): the stdlib's global generator"))


# ---------------------------------------------------------------------------
# C005/C006 — estimator clamp discipline
# ---------------------------------------------------------------------------

_CLAMP_FNS = {"torch.clamp", "torch.maximum", "torch.clamp_min", "torch.clip"}
_CLAMP_METHODS = {"clamp", "clamp_min", "clamp_", "clamp_min_", "clip"}


def _collect_assignments(fn: ast.AST) -> Dict[str, ast.AST]:
    assigns: Dict[str, ast.AST] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and (
                isinstance(node.targets[0], ast.Name)):
            assigns[node.targets[0].id] = node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name) and node.value is not None:
            assigns[node.target.id] = node.value
    return assigns


def _positive_const(node: ast.AST) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, (int, float))
            and not isinstance(node.value, bool) and node.value > 0)


def _is_clamped(node: ast.AST, assigns: Dict[str, ast.AST],
                seen: Optional[Set[str]] = None) -> bool:
    """Statically nonzero: a nonzero constant, a clamp's result, or an
    Add/Sub/Mult of clamped parts (Sub needs only one side, as the
    reference's ``safe * (safe - 1)`` idiom)."""
    seen = seen or set()
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) and node.value != 0
    if isinstance(node, ast.Call):
        d = _dotted(node.func)
        if d in _CLAMP_FNS:
            return True
        if isinstance(node.func, ast.Attribute) and node.func.attr in _CLAMP_METHODS:
            return True
        if d == "max" and any(_positive_const(a) for a in node.args):
            return True
        return False
    if isinstance(node, ast.Name):
        if node.id in seen or node.id not in assigns:
            return False
        return _is_clamped(assigns[node.id], assigns, seen | {node.id})
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Mult):
            return _is_clamped(node.left, assigns, seen) and _is_clamped(node.right, assigns, seen)
        if isinstance(node.op, (ast.Add, ast.Sub)):
            return _is_clamped(node.left, assigns, seen) or _is_clamped(node.right, assigns, seen)
    return False


def _check_estimators(tree: ast.Module, path: str, out: List[Violation]) -> None:
    var_fn = None
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name == "variance_estimate":
            var_fn = fn
        assigns = _collect_assignments(fn)
        for node in ast.walk(fn):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div) and (
                    not _is_clamped(node.right, assigns)):
                out.append(Violation(
                    path, node.lineno, "C005",
                    f"division in {fn.name!r} with an unclamped denominator — route "
                    "it through torch.clamp/torch.maximum so no NaN reaches a "
                    "QueryResult"))
    if var_fn is None:
        out.append(Violation(path, 1, "C006", "variance_estimate is missing"))
        return
    calls = set()
    for n in ast.walk(var_fn):
        if isinstance(n, ast.Call):
            calls.add(_dotted(n.func))
            if isinstance(n.func, ast.Attribute):
                calls.add("." + n.func.attr)
    if not calls & {"torch.clamp", "torch.maximum", "torch.clamp_min", ".clamp", ".clamp_min"}:
        out.append(Violation(path, var_fn.lineno, "C006",
                             "variance_estimate lost its torch.clamp/torch.maximum clamp"))
    if "torch.where" not in calls:
        out.append(Violation(path, var_fn.lineno, "C006",
                             "variance_estimate lost its torch.where small-sample gate"))


# ---------------------------------------------------------------------------
# C007 — checkpoint envelope manifest
# ---------------------------------------------------------------------------

def _check_envelope(tree: ast.Module, path: str, out: List[Violation]) -> None:
    version: Optional[int] = None
    ver_line = 1
    meta_fn = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and (
                isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_CKPT_VERSION"
                and isinstance(node.value, ast.Constant)):
            version, ver_line = node.value.value, node.lineno
        if isinstance(node, ast.FunctionDef) and node.name == "_meta":
            meta_fn = node
    if version is None or meta_fn is None:
        out.append(Violation(
            path, 1, "C007", "could not locate _CKPT_VERSION and Session._meta — the "
            "envelope manifest check has lost its anchor"))
        return
    newest = max(ENVELOPE_HISTORY)
    if version != newest:
        out.append(Violation(
            path, ver_line, "C007",
            f"_CKPT_VERSION is {version} but ENVELOPE_HISTORY's newest manifest is "
            f"v{newest} — bump the version and record the new key set in "
            "repro_torch/contracts.py"))
        return
    ret = [n.value for n in ast.walk(meta_fn)
           if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    if not ret:
        out.append(Violation(
            path, meta_fn.lineno, "C007", "_meta no longer returns a literal dict — the "
            "envelope manifest can no longer be audited statically"))
        return
    keys = set()
    for k in ret[-1].keys:
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            keys.add(k.value)
        else:
            out.append(Violation(
                path, getattr(k, "lineno", meta_fn.lineno), "C007",
                "_meta uses a non-literal key — envelope keys must be string literals"))
    manifest = ENVELOPE_HISTORY[newest]
    extra, missing = keys - manifest, manifest - keys
    if extra or missing:
        detail = []
        if extra:
            detail.append(f"unmanifested keys {sorted(extra)}")
        if missing:
            detail.append(f"missing manifest keys {sorted(missing)}")
        out.append(Violation(
            path, meta_fn.lineno, "C007",
            f"Session._meta drifted from the v{newest} envelope manifest "
            f"({'; '.join(detail)}) — changing the envelope requires a _CKPT_VERSION "
            "bump plus a new ENVELOPE_HISTORY entry"))


# ---------------------------------------------------------------------------
# C009/C010 — plan kwargs and plan nodes
# ---------------------------------------------------------------------------

def _check_plan_nodes(tree: ast.Module, path: str, out: List[Violation]) -> None:
    classes = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)}

    def derives(node: ast.ClassDef, seen: frozenset = frozenset()) -> bool:
        for b in node.bases:
            leaf = _dotted(b).split(".")[-1]
            if leaf == "PlanNode":
                return True
            if leaf in classes and leaf not in seen and derives(classes[leaf], seen | {leaf}):
                return True
        return False

    for name, node in classes.items():
        if name == "PlanNode" or not derives(node):
            continue
        defined = _class_names(node)
        missing = [a for a in ("monoid", "estimator") if a not in defined]
        if missing:
            out.append(Violation(
                path, node.lineno, "C010",
                f"PlanNode subclass {name} does not declare {' or '.join(missing)} — "
                "every plan node states its merge monoid and estimator pairing"))


def _check_plan_kwargs(tree: ast.Module, path: str, out: List[Violation]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        leaf = _dotted(node.func).split(".")[-1]
        if leaf not in _PLAN_ENTRY_POINTS:
            continue
        bad = sorted(k.arg for k in node.keywords if k.arg in DEPRECATED_PLAN_KWARGS)
        if bad:
            out.append(Violation(
                path, node.lineno, "C009",
                f"{leaf}(...) called with deprecated loose plan kwarg(s) {bad} — build a "
                "repro_torch.QuerySpec instead"))


# ---------------------------------------------------------------------------
# Suppressions (C008) and the per-file pass
# ---------------------------------------------------------------------------

def _suppressions(src: str) -> Dict[int, str]:
    """line -> suppressed rule, from real comment tokens only."""
    sup: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                m = _SUPPRESS_RE.search(tok.string)
                if m:
                    sup[tok.start[0]] = m.group(1)
    except (tokenize.TokenizeError, IndentationError, SyntaxError):
        pass
    return sup


def _rel(path: Path, root: Path) -> str:
    try:
        return str(path.relative_to(root))
    except ValueError:
        return str(path)


def lint_file(path: Path, root: Path) -> List[Violation]:
    rel = _rel(path, root)
    pos = _posix(rel)
    src = path.read_text()
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [Violation(rel, e.lineno or 1, "C000", f"syntax error: {e.msg}")]
    out: List[Violation] = []
    _check_gla(tree, rel, out)
    _check_plan_nodes(tree, rel, out)
    for suffix, names in HOT_STEP_FUNCTIONS.items():
        if pos.endswith(suffix):
            fns = _functions(tree)
            for q in names:
                if q in fns:
                    _check_syncs(fns[q], q, rel, out)
    parts = pos.split("/")
    if "repro_torch" in parts and "tests" not in parts:
        _check_rng(tree, rel, out)
    if pos.endswith("repro_torch/estimators.py"):
        _check_estimators(tree, rel, out)
    if pos.endswith("repro_torch/session.py"):
        _check_envelope(tree, rel, out)
    if "tests" not in parts:
        _check_plan_kwargs(tree, rel, out)

    sup = _suppressions(src)
    kept: List[Violation] = []
    consumed: Set[int] = set()
    for v in out:
        if sup.get(v.line) == v.code:
            consumed.add(v.line)
            if any(pos.endswith(s) and c == v.code for s, c in ALLOWLIST):
                continue
            kept.append(Violation(
                v.path, v.line, "C008",
                f"suppression of {v.code} not in the contracts ALLOWLIST "
                f"(suppressed: {v.message})"))
        else:
            kept.append(v)
    for line, code in sup.items():
        if line not in consumed:
            kept.append(Violation(rel, line, "C008",
                                  f"stale suppression: no {code} violation on this line"))
    return kept


def iter_py_files(targets: Sequence[str], root: Path) -> Iterable[Path]:
    for t in targets:
        p = (root / t) if not Path(t).is_absolute() else Path(t)
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "out" in f.parts or "__pycache__" in f.parts:
                    continue
                yield f


DEFAULT_TARGETS = ("src/repro_torch", "tests", "chip_smoke.py")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="the PyTorch port's framework-contract linter (rules C001-C010)")
    ap.add_argument("targets", nargs="*", default=list(DEFAULT_TARGETS),
                    help="files or directories to lint (default: the port, the tests "
                         "and chip_smoke.py)")
    ap.add_argument("--root", default=".", help="repo root for relative paths (default: cwd)")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()

    violations: List[Violation] = []
    n_files = 0
    for f in iter_py_files(args.targets, root):
        n_files += 1
        violations.extend(lint_file(f, root))
    for v in violations:
        print(v)
    tag = "FAIL" if violations else "OK"
    print(f"contracts: {tag} — {len(violations)} violation(s) across {n_files} file(s)")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
