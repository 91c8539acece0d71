"""Test env: CPU with 8 virtual devices so sharding tests run anywhere.

Must run before jax is imported anywhere (pytest imports conftest first).
Set ``JAX_PLATFORMS`` yourself to run the ``gpu``-marked tests on a card
(README.md, "Tests").
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """The first device when it is a GPU; skips otherwise. Decided here,
    at run time, never while a test module is imported."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (platform is {dev.platform!r})")
    return dev


@pytest.fixture(scope="session")
def dna_dir():
    """The reference project's own ``dna/`` fixtures (``APM_REFERENCE_DIR``
    names its checkout), for the compiled-binary diff only; every other
    test generates its data from a seed."""
    path = os.path.join(os.environ.get("APM_REFERENCE_DIR", ""), "dna")
    if not os.environ.get("APM_REFERENCE_DIR") or not os.path.isdir(path):
        pytest.skip("reference dna corpus not available (APM_REFERENCE_DIR)")
    return path


@pytest.fixture(scope="session")
def ref_set():
    """A seeded corpus shaped like the reference's ``small_chrY_x100.fa``
    (ACGT, 50-byte lines) with its smoke-test patterns: a 32-byte pattern
    that occurs nowhere and one 50-byte line that occurs 4 times."""
    from apm.utils.corpus import reference_shaped

    return reference_shaped(200_000, seed=20783, exact=4)


@pytest.fixture(scope="session")
def x100(ref_set):
    return ref_set[0]


@pytest.fixture(scope="session")
def pattern_20783(ref_set):
    return ref_set[1]


@pytest.fixture(scope="session")
def pattern_nonexistent(ref_set):
    return ref_set[2]


@pytest.fixture(scope="session")
def easy_fa():
    """The reference's ``easy.fa`` test input (digits, one line)."""
    return np.frombuffer(b"123123123456456\n", dtype=np.uint8)


def random_dna(n: int, seed: int, alphabet: bytes = b"ACGT\n") -> np.ndarray:
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, dtype=np.uint8)
    return alpha[rng.integers(0, len(alpha), size=n)]
