import os
import sys

# Tests run on the single real CPU device (the 512-device override is ONLY
# for the dry-run, which sets it before its own jax import).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and the CUDA toolkit; the test skips "
        "itself where torch sees no GPU",
    )
