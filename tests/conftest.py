import os
import sys
from pathlib import Path

# tests must see 1 CPU device (the dry-run sets its own 512-device flag in a
# subprocess); keep any user XLA_FLAGS out of the way.  The `make ci-sharded`
# lane opts back in to N fake host devices via REPRO_FAKE_DEVICES so the whole
# tier-1 suite exercises the camera-mesh shard_map paths.
os.environ.pop("XLA_FLAGS", None)
_fake = os.environ.get("REPRO_FAKE_DEVICES")
if _fake:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={int(_fake)}")

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

try:
    import hypothesis  # noqa: F401
except ImportError:
    from _hypothesis_shim import install as _install_hyp_shim
    _install_hyp_shim()

import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped without one")


@pytest.fixture(scope="session")
def detectors():
    """Session-cached light+server detectors (trained once, ckpt-cached);
    the recipe lives in tests/harness.py, shared with the golden writer."""
    from harness import train_default_detectors
    return train_default_detectors()


@pytest.fixture()
def scene():
    from repro.data.synthetic import MultiCameraScene, SceneConfig
    return MultiCameraScene(SceneConfig(seed=123, num_cameras=3))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
