"""Test harness: the CPU with 8 virtual devices unless ``JAX_PLATFORMS``
says otherwise, so the sharding tests run anywhere.  Tests that need a GPU
carry the ``gpu`` marker, take the ``gpu`` fixture and skip without a card;
on the card run them with ``JAX_PLATFORMS=cuda python -m pytest tests -m
gpu``."""

import os

# The backend initializes lazily, so these still win as long as no op has
# run yet, even where something imported jax first.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import pytest

from raytracercore.config import SCENES_DIR


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (BVH train steps); the default "
             "run stays under a few minutes")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy test (BVH train steps); skipped unless "
        "--runslow or RTC_RUN_SLOW=1")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips where JAX finds none")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RTC_RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow: pass --runslow (or RTC_RUN_SLOW=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def bounce_txt() -> str:
    return (SCENES_DIR / "bounce.txt").read_text(encoding="utf-8-sig")


@pytest.fixture(scope="session")
def die_txt() -> str:
    return (SCENES_DIR / "die.txt").read_text(encoding="utf-8-sig")
