"""Multi-device distribution tests on the 8-way virtual CPU mesh.

The moral equivalent of the reference's ``scripts/run_tests`` self-consistency
harness (single-config vs multi-config diff) — but run as real multi-device
programs via ``--xla_force_host_platform_device_count=8``, something the
reference could only do on the physical cluster.
"""

import jax
import numpy as np
import pytest

from apm.models.scanner import Scanner
from apm.parallel.plan import Plan, choose_strategy, get_ratio
from apm.utils.config import ApmConfig
from apm.utils.oracle import count_matches
from tests.conftest import random_dna


@pytest.fixture(scope="module", autouse=True)
def need_8_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def mk_scanner(pats, k, strategy, n_dev=8):
    cfg = ApmConfig(
        backend="xla", strategy=strategy, block_windows=128, max_devices=n_dev
    )
    return Scanner(pats, k, cfg)


@pytest.mark.parametrize("k", [0, 2])
def test_database_over_devices_vs_oracle(k):
    corpus = random_dna(5000, seed=k)
    pats = [random_dna(m, seed=50 + m) for m in [5, 18, 50]]
    got = mk_scanner(pats, k, "database_over_devices").count(corpus)
    assert got.tolist() == count_matches(corpus, pats, k)


@pytest.mark.parametrize("k", [0, 2])
def test_patterns_over_devices_vs_oracle(k):
    corpus = random_dna(3000, seed=10 + k)
    pats = [random_dna(m, seed=60 + m) for m in [5, 18, 50, 7]]
    got = mk_scanner(pats, k, "patterns_over_devices").count(corpus)
    assert got.tolist() == count_matches(corpus, pats, k)


def test_strategies_agree_with_single():
    """run_tests analog: all strategies produce identical counts."""
    corpus = random_dna(4000, seed=77)
    pats = [random_dna(m, seed=80 + m) for m in [10, 33]]
    k = 1
    want = mk_scanner(pats, k, "single", n_dev=1).count(corpus).tolist()
    for strategy in ["database_over_devices", "patterns_over_devices"]:
        got = mk_scanner(pats, k, strategy).count(corpus).tolist()
        assert got == want, strategy


def test_boundary_straddling_matches():
    """Adversarial: a match placed across every shard boundary (the case the
    reference double-counts, Report §4.3 / SURVEY §3.4)."""
    needle = b"GATTACAGATTACA"
    k = 1
    n = 4096
    corpus = random_dna(n, seed=5, alphabet=b"X").copy()  # all 'X': no noise hits
    s = 512  # db_over_devices shard width for w=128, 8 devices: s = 512
    pat_arr = np.frombuffer(needle, np.uint8)
    for d in range(1, 8):
        pos = d * s - len(needle) // 2  # straddles the boundary
        corpus[pos : pos + len(pat_arr)] = pat_arr
    want = count_matches(corpus, [needle], k)
    got = mk_scanner([needle], k, "database_over_devices").count(corpus)
    assert got.tolist() == want
    assert want[0] >= 7  # every planted needle (±band hits) was found


def test_shard_count_invariance():
    """Counts invariant to device count (race-freedom property, SURVEY §5)."""
    corpus = random_dna(2500, seed=13)
    pats = [random_dna(20, seed=14)]
    k = 2
    want = count_matches(corpus, pats, k)
    for n_dev in [1, 2, 4, 8]:
        got = mk_scanner(pats, k, "database_over_devices", n_dev=n_dev).count(corpus)
        assert got.tolist() == want, n_dev


def test_sharded_filtration_with_plants():
    """Filtration under shard_map: planted matches recovered exactly."""
    from apm.utils.corpus import plant, random_corpus, random_pattern

    pat = random_pattern(50, seed=41)
    corpus = random_corpus(8000, seed=42)
    plant(corpus, pat, [300, 2100, 5000, 7400], k=2, seed=43)
    cfg = ApmConfig(
        backend="pallas", interpret=True,
        strategy="database_over_devices", block_windows=1024, max_devices=4,
    )
    sc = Scanner([pat], 2, cfg)
    from apm.models.pipeline import make_plan

    assert make_plan(sc, len(corpus)).any_filter
    got = sc.count(corpus)
    want = count_matches(corpus, [pat], 2)
    assert got.tolist() == want
    assert want[0] >= 4


@pytest.mark.parametrize(
    "strategy", ["database_over_devices", "patterns_over_devices"]
)
def test_pallas_backend_sharded(strategy):
    """The Triton kernel (interpret) under both strategies matches the
    oracle."""
    corpus = random_dna(6000, seed=31)
    pats = [random_dna(m, seed=90 + m) for m in [10, 33, 50]]
    k = 1
    cfg = ApmConfig(
        backend="pallas",
        interpret=True,
        strategy=strategy,
        block_windows=1024,
        max_devices=4,
    )
    got = Scanner(pats, k, cfg).count(corpus)
    assert got.tolist() == count_matches(corpus, pats, k)


def test_auto_strategy_picks_and_matches():
    corpus = random_dna(3000, seed=19)
    pats = [random_dna(25, seed=20)]
    got = mk_scanner(pats, 1, "auto").count(corpus)
    assert got.tolist() == count_matches(corpus, pats, 1)


def test_auto_strategy_p_eq_ndev_routes_patterns():
    """End-to-end: with one pattern per device the measured crossover
    routes auto scans to patterns_over_devices (DESIGN §3 crossover
    matrix), and the counts still match the oracle."""
    import jax

    n_dev = len(jax.devices())
    corpus = random_dna(32 << 10, seed=41)
    pats = [random_dna(40, seed=300 + i) for i in range(n_dev)]
    sc = mk_scanner(pats, 1, "auto")
    got = sc.count(corpus)
    assert sc.last_strategy == "patterns_over_devices"
    assert got.tolist() == count_matches(corpus, pats, 1)
    # one more pattern breaks the p == n_dev equality -> database
    pats2 = pats + [random_dna(40, seed=999)]
    sc2 = mk_scanner(pats2, 1, "auto")
    got2 = sc2.count(corpus)
    assert sc2.last_strategy == "database_over_devices"
    assert got2.tolist() == count_matches(corpus, pats2, 1)


def test_auto_strategy_corr_pins_database():
    """k = 0 with a corr-eligible pattern set must stay on database
    sharding even at p == n_dev: the corr engine is flat in P (DESIGN
    §8), so pattern sharding would replicate the corpus encode per
    device for nothing (the flat_p_engine guard)."""
    import jax

    n_dev = len(jax.devices())
    corpus = random_dna(8 << 10, seed=53)
    # 50-char DNA patterns: corr-eligible (m_max >= 48, alphabet <= 16)
    pats = [random_dna(50, seed=400 + i) for i in range(n_dev)]
    cfg = ApmConfig(backend="pallas", interpret=True, strategy="auto",
                    block_windows=1024)
    sc = Scanner(pats, 0, cfg)
    got = sc.count(corpus)
    assert sc.last_strategy == "database_over_devices"
    assert got.tolist() == count_matches(corpus, pats, 0)
    # the same shapes at k = 1 are not corr-eligible -> patterns again
    sc1 = Scanner(pats, 1, cfg)
    got1 = sc1.count(corpus)
    assert sc1.last_strategy == "patterns_over_devices"
    assert got1.tolist() == count_matches(corpus, pats, 1)


# -- planner unit tests -------------------------------------------------------


def test_get_ratio_reference_parity():
    """Worked examples from Workflow.md:100-271 / main.c:21-28."""
    assert get_ratio(1.0) == 0.0
    assert get_ratio(2.0) == 1.0
    assert abs(get_ratio(0.75) - 0.5) < 1e-9  # 0.75 -> 1.5 -> 0.5
    assert get_ratio(0.5) == 0.0
    assert get_ratio(0) == float("inf")


def test_choose_strategy_shapes():
    """Pins the measured crossover rule (bench/crossover_cpu8.jsonl,
    session 2026-08-20): patterns-over-devices wins exactly at
    p == n_dev (1.22-3.88x at every corpus size); p >= 4*n_dev is a
    measured tie (0.79-1.14) -> database; p < n_dev idles devices ->
    database."""
    assert choose_strategy(10**6, 50, 6, 0, 1) == "single"
    assert choose_strategy(10**6, 50, 6, 0, 8) == "database_over_devices"
    # one pattern per device: the measured patterns-over-devices win,
    # across the measured corpus range
    assert choose_strategy(64 << 10, 50, 8, 1, 8) == "patterns_over_devices"
    assert choose_strategy(4 << 20, 50, 8, 1, 8) == "patterns_over_devices"
    # past 4x the measured range the replication cost (invisible on the
    # CPU mesh) rules patterns out
    assert choose_strategy(64 << 20, 50, 8, 1, 8) == "database_over_devices"
    # many patterns (the round-1 folklore region): measured tie -> database
    assert choose_strategy(2000, 50, 64, 0, 8) == "database_over_devices"
    assert choose_strategy(64 << 10, 50, 128, 1, 8) == "database_over_devices"
    # flat-in-P engine (k=0 corr): replicating the encode is pure loss
    assert (
        choose_strategy(64 << 10, 50, 8, 0, 8, flat_p_engine=True)
        == "database_over_devices"
    )
    # fewer windows than devices: degenerate -> single
    assert choose_strategy(6, 50, 8, 1, 8) == "single"


def test_plan_block_windows_bounds():
    for nw in [100, 10**5, 10**8]:
        for k in [0, 4, 16]:
            p = Plan.make(nw, 50, 8, k, 8)
            assert p.block_windows % 1024 == 0 or p.block_windows == 1024
            assert 1024 <= p.block_windows <= 65536


def test_sharded_dedup_filter_mixed():
    """Duplicates + mixed eligibility through the sharded database path."""
    from apm.utils.corpus import plant, random_corpus, random_pattern

    long_pat = random_pattern(50, seed=71)
    corpus = random_corpus(9000, seed=72)
    plant(corpus, long_pat, [100, 4500, 8800], k=1)
    pats = [long_pat, b"ACGTA", long_pat, b"ACGTA", long_pat]
    cfg = ApmConfig(
        backend="pallas", interpret=True, engine="auto",
        strategy="database_over_devices", block_windows=1024, max_devices=4,
    )
    got = Scanner(pats, 1, cfg).count(corpus)
    assert got.tolist() == count_matches(corpus, pats, 1)


def test_patterns_over_devices_fused_pipeline():
    """patterns-over-devices runs the full per-device pipeline (banded DP
    + filtration, static lengths per group) via placement-parallel
    dispatch. Mixed lengths, duplicates, planted fuzzy matches, 8
    devices."""
    from apm.utils.corpus import plant, random_pattern

    corpus = random_dna(20_000, seed=171)
    p50 = random_pattern(50, seed=172)
    plant(corpus, p50, [1500, 9000, 17_500], k=1, seed=173)
    pats = [p50] + [random_dna(m, seed=180 + m) for m in
                    [9, 12, 20, 20, 33, 41, 50, 64, 77, 100, 128]] + [p50]
    cfg = ApmConfig(
        backend="pallas",
        interpret=True,
        strategy="patterns_over_devices",
        block_windows=1024,
    )
    sc = Scanner(pats, 1, cfg)
    got = sc.count(corpus)
    want = count_matches(corpus, pats, 1)
    assert got.tolist() == want
    assert want[0] >= 3 and want[0] == want[-1]
    # repeated scan reuses the cached sub-scanners (and their device caches)
    assert sc.count(corpus).tolist() == want


def test_pattern_groups_balanced():
    from apm.parallel.strategies import _pattern_groups

    pats = [b"ACGT" * 0 + bytes([65 + i]) * m
            for i, m in enumerate([100, 90, 10, 11, 12, 13, 50, 51])]
    sc = Scanner(pats, 1, ApmConfig(backend="pallas", interpret=True))
    groups = _pattern_groups(sc, 4)
    assert sorted(i for g in groups for i in g) == list(range(8))
    loads = [sum(len(pats[i]) for i in g) for g in groups]
    assert max(loads) <= 2 * min(loads) + 100  # roughly balanced
    # more devices than patterns: one pattern per group, no empty groups
    groups2 = _pattern_groups(sc, 16)
    assert len(groups2) == 8 and all(len(g) == 1 for g in groups2)
