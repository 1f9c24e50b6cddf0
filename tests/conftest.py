import sys
from pathlib import Path

# allow running without PYTHONPATH=src (never touches jax device config)
SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute subprocess tests (fake-device meshes)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's kernels); skips "
        "without one")


# ---------------------------------------------------------------------------
# hypothesis fallback shim: when hypothesis is not installed, provide a
# fixed-seed stand-in so the property tests still collect and run.  Real
# hypothesis (shrinking, example database) is strictly better — install it
# via requirements-optional.txt; this shim only keeps the tier-1 suite
# dependency-light.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:
    import functools
    import random
    import types

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def _floats(min_value=-1e9, max_value=1e9):
        return _Strategy(lambda rnd: rnd.uniform(min_value, max_value))

    def _integers(min_value=0, max_value=1 << 30):
        return _Strategy(lambda rnd: rnd.randint(min_value, max_value))

    def _lists(elements, min_size=0, max_size=10):
        return _Strategy(
            lambda rnd: [elements.draw(rnd)
                         for _ in range(rnd.randint(min_size, max_size))])

    def _given(*strategies):
        def deco(f):
            @functools.wraps(f)
            def wrapper(*args, **kwargs):
                # @settings is applied above @given, i.e. onto this wrapper
                n = getattr(wrapper, "_shim_max_examples", 10)
                for i in range(n):
                    rnd = random.Random(0x5EED + i)
                    drawn = [s.draw(rnd) for s in strategies]
                    f(*args, *drawn, **kwargs)
            # pytest must see the no-arg signature, not follow __wrapped__
            # back to the original and mistake its params for fixtures
            del wrapper.__wrapped__
            return wrapper
        return deco

    def _settings(max_examples=10, **_ignored):
        def deco(f):
            f._shim_max_examples = max_examples
            return f
        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.floats, _st.integers, _st.lists = _floats, _integers, _lists
    _hyp = types.ModuleType("hypothesis")
    _hyp.given, _hyp.settings, _hyp.strategies = _given, _settings, _st
    _hyp.__is_shim__ = True
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st
