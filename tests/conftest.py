import os
import sys

# Tests must see the real single CPU device (the 512-device override is
# exclusively for launch/dryrun.py).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

try:
    from hypothesis import settings
except ImportError:
    # Minimal environments (CI cold caches, slim containers) must still
    # collect and run the suite: install the deterministic stub, which
    # expands @given into a fixed example sweep. See tests/_hypothesis_stub.
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_stub

    _hypothesis_stub.install(sys.modules)
    from hypothesis import settings

settings.register_profile("ci", max_examples=15, deadline=None)
settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: runs a kernel of the PyTorch port on an NVIDIA card; skips "
        "where torch.cuda.is_available() is false")
