# Tests run on the single real CPU device (the 512-device fake platform is
# dryrun.py-only). Keep jax x64 off; seed hypothesis deterministically.
# `hypothesis` is optional in the container: guard the import and auto-skip
# the property-based module so collection never dies on the missing dep.
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

try:
    from hypothesis import settings

    HAVE_HYPOTHESIS = True
    settings.register_profile("ci", max_examples=20, deadline=None)
    settings.load_profile("ci")
except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False

collect_ignore_glob = [] if HAVE_HYPOTHESIS else ["core/test_property_core.py"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one (run on the card)"
    )
