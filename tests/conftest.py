"""Test harness configuration.

Tests run on the CPU backend with 8 virtual XLA devices so that sharding
tests exercise a real multi-device mesh without accelerator hardware (the
reference has no test suite at all — SURVEY.md §4 — so this layer is new).

Tests that need a GPU carry the `gpu` marker and skip here. On a machine
with a GPU they run with
    TWILIGHT_TEST_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
(the platforms list keeps the 8 virtual CPU devices beside the card).
"""
import os

import jax  # noqa: E402

jax.config.update("jax_platforms",
                  os.environ.get("TWILIGHT_TEST_PLATFORMS", "cpu"))
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET = "/root/reference/dataset"
GOLDEN = os.path.join(REPO, "tests", "golden")
DATA = os.path.join(REPO, "tests", "data")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running golden tests (set TWILIGHT_RUN_SLOW=1)")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (TWILIGHT_TEST_PLATFORMS=cuda,cpu)")


def pytest_collection_modifyitems(config, items):
    if os.environ.get("TWILIGHT_RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow; set TWILIGHT_RUN_SLOW=1 to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """The first GPU, or skip: decided when the test runs, never while
    modules are imported, so every worker collects the same tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run with TWILIGHT_TEST_PLATFORMS=cuda,cpu "
                    "on a machine with one)")
    return devs[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_profile_pair(rng, ref_len, qry_len, p=6, num=1.0,
                        mutate=0.12, indel=0.04):
    """Two related one-hot profiles (ref and a mutated copy), shaped like
    what calculate_profile produces for single sequences: [len, p] f32 with
    row sums == num."""
    base = rng.integers(0, 4, size=max(ref_len, qry_len) + 32)
    ref = base[:ref_len].copy()
    qry = []
    i = 0
    while len(qry) < qry_len and i < len(base):
        r = rng.random()
        if r < indel / 2:
            i += 1  # deletion
            continue
        if r < indel:
            qry.append(rng.integers(0, 4))  # insertion
            continue
        c = base[i]
        if rng.random() < mutate:
            c = rng.integers(0, 4)
        qry.append(c)
        i += 1
    while len(qry) < qry_len:
        qry.append(rng.integers(0, 4))
    qry = np.array(qry[:qry_len])
    fr = np.zeros((ref_len, p), dtype=np.float32)
    fq = np.zeros((qry_len, p), dtype=np.float32)
    fr[np.arange(ref_len), ref] = num
    fq[np.arange(qry_len), qry] = num
    return fr, fq
