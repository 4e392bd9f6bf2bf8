import os
import sys
import types

# Tier-1 runs on a forced 8-device CPU mesh so shard_map mixer paths
# (repro.dist.sync) execute as genuine multi-device programs instead of
# collapsing to 1 device.  Must happen before the first jax import —
# conftest loads before every test module.  Subprocess probes
# (tests/test_dist.py-style) pop the parent's XLA_FLAGS and force their
# own count, so they are unaffected; launch/dryrun.py still forces 512
# in its own process per the dry-run contract.
_flags = os.environ.get("XLA_FLAGS", "")
if ("xla_force_host_platform_device_count" not in _flags
        and "jax" not in sys.modules):
    # If jax is already imported (exotic plugin, sitecustomize) the flag
    # cannot take effect; leave it unset and let the multi_device
    # fixture skip rather than aborting the whole suite.
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    from hypothesis import settings
except ModuleNotFoundError:
    # Offline container without hypothesis: install a shim so the
    # property-test modules still collect; every @given test is skipped.
    import pytest

    def _skip_given(*_args, **_kwargs):
        def deco(fn):
            return pytest.mark.skip(
                reason="hypothesis not installed")(fn)
        return deco

    class _NoopSettings:
        """No-op stand-in for hypothesis.settings (decorator + profiles)."""

        def __init__(self, *args, **kwargs):
            pass

        def __call__(self, fn):
            return fn

        @staticmethod
        def register_profile(*args, **kwargs):
            pass

        @staticmethod
        def load_profile(*args, **kwargs):
            pass

    class _DummyStrategy:
        """Inert strategy stand-in: supports the combinator surface
        (map/filter/flatmap/|) so module-level strategy expressions in
        property-test files evaluate under collection."""

        def map(self, *_a, **_k):
            return self

        def filter(self, *_a, **_k):
            return self

        def flatmap(self, *_a, **_k):
            return self

        def example(self):
            return None

        def __or__(self, _other):
            return self

        def __call__(self, *_a, **_k):
            return self

    def _strategy(*_args, **_kwargs):
        return _DummyStrategy()

    def _composite(fn):
        # @st.composite functions must stay callable (they are invoked at
        # module level to build strategies); the result is inert.
        def build(*_a, **_k):
            return _DummyStrategy()
        return build

    _st = types.ModuleType("hypothesis.strategies")
    for _name in ("integers", "floats", "lists", "tuples", "sampled_from",
                  "booleans", "just", "text", "one_of", "none", "data",
                  "dictionaries", "sets", "binary", "characters",
                  "permutations"):
        setattr(_st, _name, _strategy)
    _st.composite = _composite
    _st.SearchStrategy = _DummyStrategy
    # any strategy name we did not anticipate still resolves (PEP 562)
    _st.__getattr__ = lambda _name: _strategy

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _skip_given
    _hyp.settings = _NoopSettings
    _hyp.strategies = _st
    _hyp.assume = lambda *a, **k: True
    _hyp.example = _skip_given
    _hyp.HealthCheck = types.SimpleNamespace(all=staticmethod(lambda: []))
    # cover both import spellings: ``from hypothesis import strategies``
    # AND ``import hypothesis.strategies as st`` in property-test modules
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st
    settings = _NoopSettings

settings.register_profile("ci", deadline=None, max_examples=25)
settings.load_profile("ci")

import pytest  # noqa: E402  (after the hypothesis shim)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multi_device: exercises real multi-device shard_map programs "
        "(needs the forced 8-device CPU mesh)")
    config.addinivalue_line(
        "markers",
        "chaos: fault-injection storms (repro.faults) — seeded chaos "
        "traces over the NDMP engines and the slot loop")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips "
        "where torch.cuda.is_available() is false")


@pytest.fixture
def multi_device():
    """The 8-device CPU mesh tier-1 runs on.  Returns the device count;
    skips if the XLA force flag did not take (e.g. jax was pre-imported
    by an exotic plugin)."""
    import jax
    n = jax.device_count()
    if n < 8:
        pytest.skip(f"needs >= 8 host devices, have {n}")
    return n
