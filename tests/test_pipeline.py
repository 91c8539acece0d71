"""Regression tests for the shared scan pipeline (apm.models.pipeline).

Early versions carried three hand-copies of the filtration orchestration
that diverged (wrong multihost halo, missing density fallback, unguarded
engine); these tests pin the unified pipeline's behavior, including those
crash cases.
"""

import os
import tempfile

import jax
import numpy as np
import pytest

from apm.models.scanner import Scanner
from apm.models.pipeline import make_plan
from apm.parallel.multihost import count_multihost
from apm.utils.config import ApmConfig
from apm.utils.corpus import plant, random_pattern
from apm.utils.oracle import count_matches
from tests.conftest import random_dna


@pytest.fixture(scope="module", autouse=True)
def need_8_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _tmpfile(data: np.ndarray) -> str:
    with tempfile.NamedTemporaryFile(suffix=".fa", delete=False) as f:
        f.write(data.tobytes())
        return f.name


PALLAS = dict(backend="pallas", interpret=True, block_windows=1024)


def test_multihost_halo_regression():
    """m_max=127, k=1: filtration-eligible and m_max + 2k > round_up(m_max,
    128) — the piece correlation needs the ``2k`` halo margin, which an
    early multihost copy of the pipeline left out."""
    data = random_dna(6000, seed=11)
    pat = random_pattern(127, seed=12)
    plant(data, pat, [700, 3500], k=1, seed=13)
    path = _tmpfile(data)
    try:
        sc = Scanner([pat], 1, ApmConfig(**PALLAS))
        assert make_plan(sc, len(data)).any_filter
        got = [int(c) for c in count_multihost(sc, path)[:1]]
        want = count_matches(data, [pat], 1)
        assert got == want
        assert want[0] >= 2
    finally:
        os.unlink(path)


def test_multihost_dense_fallback():
    """Degenerate low-entropy corpus: every window is a candidate. The
    multihost path must take the banded-DP density fallback, not stage an
    unbounded hot-row bucket."""
    data = np.full(5000, ord("A"), dtype=np.uint8)
    pat = b"A" * 60
    path = _tmpfile(data)
    try:
        sc = Scanner([pat], 2, ApmConfig(**PALLAS))
        assert make_plan(sc, len(data)).any_filter
        got = [int(c) for c in count_multihost(sc, path)[:1]]
        assert got == count_matches(data, [pat], 2)
    finally:
        os.unlink(path)


def test_multihost_narrow_dtype_engine_gating():
    """engine="dp" routes every pattern to the banded DP — in every entry
    point, the multihost one included (its copy of the pipeline once
    passed the engine through unguarded)."""
    data = random_dna(4000, seed=21)
    pat = random_pattern(64, seed=22)
    path = _tmpfile(data)
    try:
        assert make_plan(Scanner([pat], 1, ApmConfig(**PALLAS)), 4000).any_filter
        cfg = ApmConfig(engine="dp", **PALLAS)
        sc = Scanner([pat], 1, cfg)
        plan = make_plan(sc, len(data))
        assert not plan.any_filter and plan.any_dp
        got = [int(c) for c in count_multihost(sc, path)[:1]]
        assert got == count_matches(data, [pat], 1)
    finally:
        os.unlink(path)


def _overflow_corpus():
    """~100 planted matches in distinct staging rows: more hot rows than
    the on-device bucket (MAX_HOT=64) but below the density threshold →
    exercises the host-staged overflow recovery."""
    n = 300_000
    data = random_dna(n, seed=31)
    pat = random_pattern(50, seed=32)
    sites = list(range(1000, 287_000, 2900))  # 99 sites, ~1 per row (wf=128)
    plant(data, pat, sites, k=1, seed=33)
    return data, pat


def test_overflow_recovery_single_device():
    data, pat = _overflow_corpus()
    sc = Scanner([pat], 1, ApmConfig(strategy="single", **PALLAS))
    assert make_plan(sc, len(data)).any_filter
    assert sc.count(data).tolist() == count_matches(data, [pat], 1)


def test_fused_verification_sharded():
    """Hot rows spread over 8 shards (~13 each): each device verifies its
    own rows on device; counts come straight from the psum'd vcnt."""
    data, pat = _overflow_corpus()
    sc = Scanner(
        [pat],
        1,
        ApmConfig(strategy="database_over_devices", **PALLAS),
    )
    assert sc.count(data).tolist() == count_matches(data, [pat], 1)


def test_overflow_recovery_sharded():
    """70 matches concentrated in shard 0 (> MAX_HOT=64 hot rows in one
    shard, still below the density threshold): the sharded path must fetch
    the row maps and recover host-staged."""
    n = 300_000
    data = random_dna(n, seed=41)
    pat = random_pattern(50, seed=42)
    sites = list(range(1000, 1000 + 70 * 256, 256))  # 70 rows of shard 0
    plant(data, pat, sites, k=1, seed=43)
    sc = Scanner(
        [pat],
        1,
        ApmConfig(strategy="database_over_devices", **PALLAS),
    )
    assert sc.count(data).tolist() == count_matches(data, [pat], 1)


def _concentrated_corpus():
    """100 planted matches packed into the FIRST 64 KB chunk: that chunk
    overflows its on-device hot-row bucket (~100 hot rows > max_hot=64 at
    512 rows/chunk) while GLOBAL density stays sparse (100 << 234-row
    threshold at n=600k) — the regime the device-side overflow recovery
    (fused.count_hot_batch) exists for."""
    n = 600_000
    data = random_dna(n, seed=51)
    pat = random_pattern(50, seed=52)
    sites = list(range(700, 700 + 100 * 512, 512))  # rows 5..404 of chunk 0
    plant(data, pat, sites, k=1, seed=53)
    return data, pat


def _overflow_scanner(pat):
    return Scanner(
        [pat],
        1,
        ApmConfig(strategy="single", chunk_bytes=65536, **PALLAS),
    )


def test_overflow_device_recovery(monkeypatch):
    """The preferred overflow recovery re-verifies hot rows ON DEVICE
    (count_hot_batch over the resident staging + row map) — no host
    re-staging, no verify_rows_host."""
    from apm.ops import fused
    from apm.models import pipeline

    data, pat = _concentrated_corpus()
    calls = {"dev": 0, "host": 0}
    orig = fused.count_hot_batch
    monkeypatch.setattr(
        fused, "count_hot_batch",
        lambda *a, **kw: (calls.__setitem__("dev", calls["dev"] + 1),
                          orig(*a, **kw))[1],
    )
    orig_host = pipeline.verify_rows_host
    monkeypatch.setattr(
        pipeline, "verify_rows_host",
        lambda *a, **kw: (calls.__setitem__("host", calls["host"] + 1),
                          orig_host(*a, **kw))[1],
    )
    sc = _overflow_scanner(pat)
    assert sc.count(data).tolist() == count_matches(data, [pat], 1)
    assert calls["dev"] >= 1, "device-side overflow recovery not taken"
    assert calls["host"] == 0, "host-staged fallback should not run"


def test_overflow_device_recovery_multibatch(monkeypatch):
    """n_hot > OVERFLOW_BATCH dispatches ceil(n_hot/n_batch) batch kernels
    whose sums replace the chunk's vcnt."""
    from apm.ops import fused

    monkeypatch.setattr(fused, "OVERFLOW_BATCH", 32)  # 100 hot -> >=4 batches
    data, pat = _concentrated_corpus()
    calls = {"dev": 0}
    orig = fused.count_hot_batch
    monkeypatch.setattr(
        fused, "count_hot_batch",
        lambda *a, **kw: (calls.__setitem__("dev", calls["dev"] + 1),
                          orig(*a, **kw))[1],
    )
    sc = _overflow_scanner(pat)
    assert sc.count(data).tolist() == count_matches(data, [pat], 1)
    assert calls["dev"] >= 4


def test_overflow_cap_host_fallback(monkeypatch):
    """Past the compaction cap the chunk falls back to the host-staged
    recovery (verify_rows_host) — counts stay exact."""
    from apm.ops import fused
    from apm.models import pipeline

    monkeypatch.setattr(fused, "OVERFLOW_BATCH", 32)
    monkeypatch.setattr(fused, "OVERFLOW_CAP", 64)  # 100 hot rows > cap
    data, pat = _concentrated_corpus()
    calls = {"host": 0}
    orig_host = pipeline.verify_rows_host
    monkeypatch.setattr(
        pipeline, "verify_rows_host",
        lambda *a, **kw: (calls.__setitem__("host", calls["host"] + 1),
                          orig_host(*a, **kw))[1],
    )
    sc = _overflow_scanner(pat)
    assert sc.count(data).tolist() == count_matches(data, [pat], 1)
    assert calls["host"] >= 1, "cap overflow must take the host fallback"


def test_pick_max_hot_properties():
    """Bucket sizing: ROW_ALIGN-aligned, floored at MAX_HOT, capped, and
    growing with the chunk."""
    from apm.ops.fused import MAX_HOT, MAX_HOT_CAP, ROW_ALIGN, pick_max_hot

    plens = (20, 20, 0)
    small = pick_max_hot(512, 128, plens, 1)
    big = pick_max_hot(2 << 20, 128, plens, 1)
    for v in (small, big):
        assert v % ROW_ALIGN == 0 and MAX_HOT <= v <= MAX_HOT_CAP
    assert big >= small
    assert big == MAX_HOT_CAP  # a 256 MB chunk earns the full bucket
    # Expensive verify (long patterns, high k) stays at the floor.
    assert pick_max_hot(512, 128, (120,) * 32, 8) == MAX_HOT


def test_dp_step_resolution_is_explicit():
    """One place decides how the DP step runs: the kernel on a GPU or under
    an explicit interpret=True, the plain XLA band on the CPU; asking for
    the compiled kernel without a GPU raises instead of falling back."""
    from apm.ops.pallas_kernel import DPStep, resolve_impl

    assert jax.devices()[0].platform == "cpu"
    assert resolve_impl("auto", False) == "xla"
    assert resolve_impl("xla", False) == "xla"
    assert resolve_impl("auto", True) == "pallas"
    assert resolve_impl("pallas", True) == "pallas"
    with pytest.raises(ValueError, match="needs a GPU"):
        resolve_impl("pallas", False)
    sc = Scanner([b"ACGTACGTAC"], 1, ApmConfig(backend="pallas", interpret=True))
    assert make_plan(sc, 10_000).dp == DPStep("pallas", True)
    assert make_plan(Scanner([b"ACGTACGTAC"], 1), 10_000).dp == DPStep("xla")
    with pytest.raises(ValueError):
        Scanner([b"ACGT"], 1, ApmConfig(backend="pallas")).count(b"ACGT" * 9)


def test_plan_halo_consistency():
    """The halo must satisfy every engine for every m_max, k (the quantity
    early hand-copies of the pipeline disagreed on)."""
    for m, k in [(127, 1), (128, 1), (126, 2), (255, 4), (12, 1)]:
        sc = Scanner([b"G" * m], k, ApmConfig(**PALLAS))
        plan = make_plan(sc, 10_000)
        assert plan.halo >= m + 2 * k
        assert plan.halo % 128 == 0


@pytest.mark.parametrize(
    "pats,k,want",
    [
        # k = 0, heavy set: the correlation takes the whole set
        ([b"ACGT" * 15], 0, "corr"),
        # k = 0, light set: banded DP at k = 0
        ([b"ACGTACGTAC", b"GATTACA"], 0, "dp"),
        # k = 1, long patterns: filtration for all
        ([b"ACGT" * 15, b"TTGCA" * 12], 1, "filter"),
        # k = 1, one long + one short: filtration + banded DP
        ([b"ACGT" * 15, b"GATTACA"], 1, "mixed"),
        # k = 6, mid-length (banded tier, no correlation form): banded DP
        ([b"ACGT" * 15], 6, "dp"),
        # wide alphabet: no correlation channels, banded DP
        ([bytes(range(32, 92))], 1, "dp"),
    ],
)
def test_make_plan_routes_by_input(pats, k, want):
    """Routing follows k, lengths, pattern count and alphabet only."""
    plan = make_plan(Scanner(pats, k), 1 << 20)
    got = (
        "corr" if plan.use_corr
        else "mixed" if plan.any_filter and plan.any_dp
        else "filter" if plan.any_filter
        else "dp"
    )
    assert got == want, plan
    n = len(pats)
    covered = [
        plan.use_corr or bool(plan.plens_filter[i]) != bool(plan.plens_dp[i])
        for i in range(n)
    ]
    assert all(covered), plan  # every pattern runs exactly one engine
