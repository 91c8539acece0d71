"""Pigeonhole filtration (piece-correlation phase 1 + banded verification):
conformance + adversarial density tests, and the find() position paths."""

import numpy as np
import pytest

from apm.models.scanner import Scanner
from apm.ops.filtration import filter_eligible, pieces_of
from apm.utils.config import ApmConfig
from apm.utils.oracle import count_matches
from tests.conftest import random_dna


def counts_with(corpus, pats, k, engine):
    cfg = ApmConfig(
        backend="pallas",
        interpret=True,
        strategy="single",
        block_windows=1024,
        engine=engine,
    )
    return Scanner(pats, k, cfg).count(np.asarray(corpus)).tolist()


def plant_fuzzy(corpus, pat, k, positions, rng):
    alpha = np.frombuffer(b"ACGT", np.uint8)
    for pos in positions:
        w = pat.copy()
        for _ in range(k):
            i = int(rng.integers(0, len(w)))
            w[i] = alpha[rng.integers(0, 4)]
        corpus[pos : pos + len(w)] = w


@pytest.mark.parametrize("k", [1, 2, 3])
def test_filter_with_planted_fuzzy_matches(k):
    rng = np.random.default_rng(7 * k)
    corpus = random_dna(4000, seed=k, alphabet=b"ACGT").copy()
    pats = [random_dna(50, seed=100 + k, alphabet=b"ACGT"),
            random_dna(33, seed=200 + k, alphabet=b"ACGT")]
    for pat in pats:
        plant_fuzzy(corpus, pat, k, rng.integers(0, 3800, size=8), rng)
    want = count_matches(corpus, pats, k)
    assert counts_with(corpus, pats, k, "auto") == want
    assert counts_with(corpus, pats, k, "dp") == want


def test_filter_dense_fallback():
    """Low-entropy corpus: everything is a candidate -> DP fallback path."""
    corpus = np.frombuffer(b"A" * 6000, np.uint8)
    pats = [np.frombuffer(b"A" * 40 + b"C" * 10, np.uint8)]
    k = 2
    want = count_matches(corpus, pats, k)
    assert counts_with(corpus, pats, k, "auto") == want


def test_filter_boundary_straddling():
    """Fuzzy matches planted across every fold-row boundary (wf=128)."""
    rng = np.random.default_rng(3)
    corpus = random_dna(4096, seed=9, alphabet=b"ACGT").copy()
    pat = random_dna(50, seed=10, alphabet=b"ACGT")
    k = 2
    positions = [r * 128 - 25 for r in range(1, 30)]
    plant_fuzzy(corpus, pat, k, positions, rng)
    want = count_matches(corpus, [pat], k)
    assert counts_with(corpus, [pat], k, "auto") == want


def test_filter_mixed_eligibility():
    """Short patterns route to DP, long ones to filtration, in one scan."""
    corpus = random_dna(3000, seed=21)
    pats = [b"ACG", random_dna(50, seed=22), b"ACGTACGT"]
    k = 1
    assert counts_with(corpus, pats, k, "auto") == count_matches(corpus, pats, k)


def test_filter_k0_exact():
    corpus = random_dna(3000, seed=31).copy()
    pat = random_dna(30, seed=32)
    for pos in [100, 1000, 2500]:
        corpus[pos : pos + 30] = pat
    want = count_matches(corpus, [pat], 0)
    assert want == [3]
    for engine in ("auto", "dp", "corr"):  # k = 0: DP at k = 0 or the conv
        assert counts_with(corpus, [pat], 0, engine) == want


# -- static helpers -----------------------------------------------------------


def test_pieces_partition():
    for m in [9, 10, 33, 50]:
        for k in [0, 1, 2, 4]:
            tab = pieces_of(m, k)
            assert len(tab) == k + 1
            assert tab[0][0] == 0
            assert sum(li for _, li in tab) == m
            for (o1, l1), (o2, _) in zip(tab, tab[1:]):
                assert o1 + l1 == o2


def test_eligibility_rules():
    from apm.ops.filtration import FP1_LMIN, banded_j, tier_of

    assert not filter_eligible(50, 0)  # k = 0 is exact matching, no phase 1
    assert filter_eligible(50, 1)
    assert filter_eligible(50, 4)  # l=10 >= FP1_LMIN
    assert not filter_eligible(44, 4)  # l=8: exact tier, too short to scan
    assert not filter_eligible(20, 2)  # l=6 < 8
    assert FP1_LMIN == 10
    # k in [5, 16]: exact tier for long patterns, banded tier for mid.
    assert tier_of(84, 5) == (6, 0)  # l=14 exact pieces
    assert tier_of(50, 5) == (3, 1)  # banded: j=3, l=16, 1 error each
    assert tier_of(41, 5) is None  # l=13 < 14
    assert tier_of(98, 6) == (7, 0)
    assert tier_of(97, 6) == (4, 1)
    assert tier_of(14 * 17, 16) == (17, 0)
    assert tier_of(16 * 9, 16) == (9, 1)
    assert tier_of(140, 16) is None  # 140//9=15 < 16
    assert not filter_eligible(50, 17)  # beyond K_MAX
    assert filter_eligible(84, 5)  # exact tier, l=14
    assert not filter_eligible(50, 5)  # banded tier: no correlation form
    for k in range(5, 17):
        assert k // banded_j(k) == 1  # pigeonhole: 1 error per piece


def test_filter_maximal_left_shift_at_row_boundary():
    """A match whose only certificate is a piece shifted by exactly -k,
    with the window start on the first and last window of a staging row:
    the piece correlation's row-any candidacy must still see it (halo
    margin) and phase 2 must verify it."""
    rng = np.random.default_rng(5)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    corpus = alpha[rng.integers(0, 4, size=2048)].copy()
    pat = alpha[rng.integers(0, 4, size=48)]
    k = 2
    # windowed text = pattern with its first k chars deleted, plus k junk
    # chars at the end -> distance <= k via k deletions + k insertions?
    # Use substitut-free construction: delete first k, append k chars.
    w = np.concatenate([pat[k:], alpha[rng.integers(0, 4, size=k)]])
    for j in [128, 256 - 1, 512]:  # lane 0, lane wf-1, lane 0 (wf=128)
        corpus[j : j + len(w)] = w
    want = count_matches(corpus, [pat], k)
    assert want[0] >= 3
    got = counts_with(corpus, [pat], k, "auto")
    assert got == want


@pytest.mark.parametrize("k", [7, 12])
def test_large_k_dp_only(k):
    """k beyond filtration eligibility: banded kernel with wide bands."""
    corpus = random_dna(1200, seed=k)
    pats = [random_dna(30, seed=k + 1), random_dna(14, seed=k + 2)]
    assert counts_with(corpus, pats, k, "auto") == count_matches(corpus, pats, k)


def test_empty_and_tiny_corpora():
    pats = [b"ACGT"]
    for raw in [b"", b"A", b"ACG", b"ACGT"]:
        corpus = np.frombuffer(raw, np.uint8)
        for k in [0, 1, 5]:
            got = counts_with(corpus, pats, k, "auto")
            assert got == count_matches(corpus, pats, k), (raw, k)


def test_randomized_cross_engine_matrix():
    """Breadth sweep: random (n, patterns, k) across engines and backends
    must all agree with the oracle — the run_tests philosophy, randomized."""
    rng = np.random.default_rng(123)
    for trial in range(8):
        n = int(rng.integers(200, 4000))
        k = int(rng.integers(0, 5))
        pats = [
            random_dna(int(rng.integers(1, 55)), seed=1000 + 10 * trial + i)
            for i in range(int(rng.integers(1, 5)))
        ]
        corpus = random_dna(n, seed=2000 + trial)
        want = count_matches(corpus, pats, k)
        for engine in ("auto", "dp"):
            got = counts_with(corpus, pats, k, engine)
            assert got == want, (trial, n, k, engine)


def test_binary_safety_full_byte_range():
    """Arbitrary bytes (NUL, 0xFF, newlines) in corpus and patterns.

    The reference treats patterns as C strings (argv cannot carry NUL);
    this framework is byte-clean end to end."""
    rng = np.random.default_rng(77)
    corpus = rng.integers(0, 256, size=3000).astype(np.uint8)
    pats = [
        np.array([0, 0, 255, 10, 65] * 6, dtype=np.uint8),  # NULs + 0xFF
        rng.integers(0, 256, size=33).astype(np.uint8),
        np.array([0] * 12, dtype=np.uint8),  # all-NUL pattern
    ]
    corpus[500:530] = pats[0]
    corpus[1500:1512] = pats[2]
    for k in [0, 1, 2]:
        want = count_matches(corpus, pats, k)
        for engine in ("auto", "dp"):
            assert counts_with(corpus, pats, k, engine) == want, (k, engine)


def np_positions(corpus, pat, k):
    from apm.utils.oracle import banded_distances

    d = banded_distances(corpus, pat, k)
    return list(np.nonzero(d <= k)[0])


@pytest.mark.parametrize("k", [0, 1, 2])
def test_find_positions(k):
    """Scanner.find returns exact match positions (beyond the reference)."""
    from apm.models.scanner import Scanner

    rng = np.random.default_rng(9)
    corpus = random_dna(3000, seed=50 + k).copy()
    long_pat = random_dna(50, seed=51)
    short_pat = random_dna(6, seed=52)  # filtration-ineligible at k>=1
    plant_fuzzy(corpus, long_pat, k, [111, 1502, 2750], rng)
    cfg = ApmConfig(
        backend="pallas", interpret=True, strategy="single",
        block_windows=1024,
    )
    sc = Scanner([long_pat, short_pat, long_pat], k, cfg)  # incl. duplicate
    got = sc.find(corpus)
    assert len(got) == 3
    for pi, pat in enumerate([long_pat, short_pat, long_pat]):
        assert list(got[pi]) == np_positions(corpus, pat, k), (k, pi)
    # counts and positions must agree
    counts = sc.count(corpus)
    for pi in range(3):
        assert len(got[pi]) == counts[pi]


def test_find_limit_and_tail():
    from apm.models.scanner import Scanner

    corpus = random_dna(400, seed=60).copy()
    pat = random_dna(50, seed=61)
    corpus[390:400] = pat[:10]  # EOF-truncated region activity
    cfg = ApmConfig(backend="pallas", interpret=True, block_windows=1024)
    sc = Scanner([pat], 3, cfg)
    full = sc.find(corpus)[0]
    assert list(full) == np_positions(corpus, pat, 3)
    lim = sc.find(corpus, limit=2)[0]
    assert list(lim) == list(full[:2])


def test_find_dense_matches_device_path():
    """find() on a corpus where nearly EVERY window matches: the device
    mask path must return all positions exactly, with no host-oracle
    re-scan of hot rows."""
    from apm.models.scanner import Scanner

    corpus = np.full(6000, ord("A"), dtype=np.uint8)
    pat = np.full(50, ord("A"), dtype=np.uint8)
    pat[-1] = ord("C")  # k=1 still matches every all-A window
    cfg = ApmConfig(backend="pallas", interpret=True, block_windows=1024)
    sc = Scanner([pat], 1, cfg)
    got = sc.find(corpus)[0]
    want = np_positions(corpus, pat, 1)
    assert len(want) > 5000 and list(got) == want


def test_find_multichunk_multibatch():
    """Positions across multiple staged chunks and gather batches, with a
    second (short) pattern in the same scan."""
    from apm.models.scanner import Scanner

    rng = np.random.default_rng(77)
    corpus = random_dna(40000, seed=78).copy()
    pat = random_dna(50, seed=79)
    plants = list(range(100, 39000, 977))
    plant_fuzzy(corpus, pat, 2, plants, rng)
    short_pat = random_dna(6, seed=80)
    cfg = ApmConfig(
        backend="pallas", interpret=True, block_windows=1024,
        chunk_bytes=8192,  # forces several chunks
    )
    sc = Scanner([pat, short_pat], 2, cfg)
    got = sc.find(corpus)
    assert list(got[0]) == np_positions(corpus, pat, 2)
    assert list(got[1]) == np_positions(corpus, short_pat, 2)
    assert len(got[0]) >= len(plants)


def test_find_dense_sweep_ineligible_overflow():
    """A short pattern (k=2) on a corpus where every window matches: the
    verdict-mask sweep (sweep_positions_chunk) must resolve every position
    on device, including overflow past FIND_BATCH hot rows and multiple
    chunks."""
    from apm.models.scanner import Scanner

    corpus = np.full(30000, ord("A"), dtype=np.uint8)
    pat = np.full(8, ord("A"), dtype=np.uint8)
    pat[3] = ord("C")  # k=2 still matches every all-A window
    cfg = ApmConfig(
        backend="pallas", interpret=True, block_windows=1024,
        chunk_bytes=8192,
    )
    sc = Scanner([pat], 2, cfg)
    got = sc.find(corpus)[0]
    want = np_positions(corpus, pat, 2)
    assert len(want) > 25000 and list(got) == want


@pytest.mark.parametrize("k", [5, 7])
def test_find_dense_sweep_high_k(k):
    """High-k short patterns through the device sweep, sparse matches +
    EOF tail."""
    from apm.models.scanner import Scanner

    rng = np.random.default_rng(31 * k)
    corpus = random_dna(12000, seed=500 + k).copy()
    pat = random_dna(18, seed=501 + k)
    plant_fuzzy(corpus, pat, k, [77, 5003, 11900], rng)
    cfg = ApmConfig(
        backend="pallas", interpret=True, block_windows=1024,
        chunk_bytes=4096,
    )
    sc = Scanner([pat], k, cfg)
    got = sc.find(corpus)[0]
    assert list(got) == np_positions(corpus, pat, k)
    assert len(got) == sc.count(corpus)[0]


def test_find_mixed_eligibility_same_scan():
    """One scan mixing a 50-char pattern (filtration in count()), a 6-char
    one (banded DP in count()), and a duplicate — find()'s positions for
    each must match the oracle and agree with count()."""
    from apm.models.scanner import Scanner

    rng = np.random.default_rng(99)
    corpus = random_dna(20000, seed=600).copy()
    long_pat = random_dna(50, seed=601)
    short_pat = random_dna(6, seed=602)
    plant_fuzzy(corpus, long_pat, 2, [1000, 9000, 17000], rng)
    cfg = ApmConfig(
        backend="pallas", interpret=True, block_windows=1024,
        chunk_bytes=8192,
    )
    sc = Scanner([short_pat, long_pat, short_pat], 2, cfg)
    got = sc.find(corpus)
    counts = sc.count(corpus)
    for pi, pat in enumerate([short_pat, long_pat, short_pat]):
        assert list(got[pi]) == np_positions(corpus, pat, 2), pi
        assert len(got[pi]) == counts[pi]


@pytest.mark.parametrize("k", [5, 6, 8])
def test_high_k_filtration_vs_oracle(k):
    """Exact-piece filtration at k in [5, 8] for long patterns (piece
    length >= 14). Planted k-error occurrences recovered exactly."""
    from apm.ops.filtration import filter_eligible
    from apm.utils.corpus import plant, random_pattern

    m = 14 * (k + 1)
    assert filter_eligible(m, k)
    corpus = random_dna(40_000, seed=300 + k)
    pat = random_pattern(m, seed=310 + k)
    plant(corpus, pat, [900, 20_000, 38_000], k=k, seed=320 + k)
    cfg = ApmConfig(backend="pallas", interpret=True, block_windows=1024)
    sc = Scanner([pat], k, cfg)
    from apm.models.pipeline import make_plan

    assert make_plan(sc, len(corpus)).any_filter
    got = sc.count(corpus).tolist()
    want = count_matches(corpus, [pat], k)
    assert got == want
    assert want[0] >= 3


@pytest.mark.parametrize("k", [5, 6, 8])
def test_banded_tier_mid_length_vs_oracle(k):
    """Banded-piece tier: mid-length patterns at k in [5, 8] (too short
    for k+1 exact pieces) have no correlation phase 1 and run the banded
    DP. Planted k-error occurrences recovered exactly."""
    from apm.ops.filtration import tier_of
    from apm.utils.corpus import plant, random_pattern

    m = 14 * (k + 1) - 7  # just below the exact-tier threshold
    j, kp = tier_of(m, k)
    assert kp == 1 and j == k // 2 + 1
    corpus = random_dna(30_000, seed=400 + k)
    pat = random_pattern(m, seed=410 + k)
    plant(corpus, pat, [700, 15_000, 28_000], k=k, seed=420 + k)
    cfg = ApmConfig(backend="pallas", interpret=True, block_windows=1024)
    got = Scanner([pat], k, cfg).count(corpus).tolist()
    want = count_matches(corpus, [pat], k)
    assert got == want
    assert want[0] >= 3


def test_banded_tier_boundary_drift_certificates():
    """Adversarial alignments: all k errors concentrated as deletions at
    the pattern head (last piece certifies at maximal left drift), as
    insertions at the head (maximal right drift), and all errors inside
    one middle piece (endpoint pieces certify with zero errors)."""
    k = 6
    m = 70  # banded tier: j=4, l=17
    from apm.ops.filtration import tier_of

    assert tier_of(m, k) == (4, 1)
    rng = np.random.default_rng(88)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pat = alpha[rng.integers(0, 4, size=m)]
    windows = []
    # k deletions at the head: window = pat[k:] + k junk
    windows.append(np.concatenate([pat[k:], alpha[rng.integers(0, 4, size=k)]]))
    # k insertions at the head: window = junk*k + pat[:-k]
    windows.append(np.concatenate([alpha[rng.integers(0, 4, size=k)], pat[:-k]]))
    # k substitutions inside piece 1 (offsets [17, 34)): endpoint pieces
    # certify with zero errors and zero drift
    w2 = pat.copy()
    for i in range(18, 24):
        w2[i] = alpha[(int(np.nonzero(alpha == w2[i])[0][0]) + 1) % 4]
    windows.append(w2)
    corpus = random_dna(8000, seed=89).copy()
    for i, w in enumerate(windows):
        pos = 500 + i * 2000
        corpus[pos : pos + len(w)] = w
    want = count_matches(corpus, [pat], k)
    assert want[0] >= 3  # every construction is a real match
    cfg = ApmConfig(backend="pallas", interpret=True, block_windows=1024)
    got = Scanner([pat], k, cfg).count(corpus).tolist()
    assert got == want


@pytest.mark.parametrize("k", [9, 12, 16])
def test_k_beyond_8_filtration_vs_oracle(k):
    """Both tiers extended to k in [9, 16]: one long (exact-tier) and one
    mid-length (banded-tier) pattern in the same scan, vs the oracle."""
    from apm.ops.filtration import banded_j, tier_of
    from apm.utils.corpus import plant, random_pattern

    m_long = 14 * (k + 1)
    m_mid = 16 * banded_j(k)
    assert tier_of(m_long, k)[1] == 0
    assert tier_of(m_mid, k)[1] == 1
    corpus = random_dna(20_000, seed=500 + k)
    p_long = random_pattern(m_long, seed=510 + k)
    p_mid = random_pattern(m_mid, seed=520 + k)
    plant(corpus, p_long, [900, 9_000], k=k, seed=530 + k)
    plant(corpus, p_mid, [4_000, 16_000], k=k, seed=540 + k)
    cfg = ApmConfig(
        backend="pallas", interpret=True, engine="auto",
        block_windows=1024,
    )
    got = Scanner([p_long, p_mid], k, cfg).count(corpus).tolist()
    want = count_matches(corpus, [p_long, p_mid], k)
    assert got == want
    assert min(want) >= 2


def test_mixed_tiers_one_scan():
    """Exact-tier, banded-tier, and DP-fallback patterns together."""
    k = 6
    pats = [
        random_dna(98, seed=601),  # exact tier (l=14)
        random_dna(60, seed=602),  # banded tier (j=4, l=15)
        random_dna(20, seed=603),  # DP fallback
    ]
    corpus = random_dna(12_000, seed=600)
    want = count_matches(corpus, pats, k)
    assert counts_with(corpus, pats, k, "auto") == want
    assert counts_with(corpus, pats, k, "dp") == want


def test_find_pos_cap_overflow_mask_fallback(monkeypatch):
    """When a verdict-mask batch holds more hits than POS_CAP, the host
    must fall back to the packed-mask fetch — shrink POS_CAP so a small
    dense corpus overflows it, for a short and a long pattern."""
    import apm.ops.fused as fused
    from apm.models.scanner import Scanner

    monkeypatch.setattr(fused, "POS_CAP", 8)
    corpus = np.full(9000, ord("A"), dtype=np.uint8)
    short = np.full(8, ord("A"), dtype=np.uint8)
    longp = np.full(48, ord("A"), dtype=np.uint8)
    cfg = ApmConfig(
        backend="pallas", interpret=True, block_windows=1024,
        chunk_bytes=4096,
    )
    sc = Scanner([short, longp], 2, cfg)
    got = sc.find(corpus)
    assert list(got[0]) == np_positions(corpus, short, 2)
    assert list(got[1]) == np_positions(corpus, longp, 2)


def test_find_dense_gpos_branch(monkeypatch):
    """Dense-scattered regime: many hot rows (n_hot > FIND_BATCH) but few
    hits per group — positions must come from the sweep's per-group
    compaction (gpos decode), not gather batches. FIND_BATCH is shrunk so
    a small interpret-mode corpus overflows it."""
    import apm.ops.fused as fused
    from apm.models.scanner import Scanner

    monkeypatch.setattr(fused, "FIND_BATCH", 8)
    corpus = random_dna(40000, seed=90).copy()
    pat = random_dna(8, seed=91)
    for pos in range(50, 39000, 300):
        corpus[pos:pos + 8] = pat
    cfg = ApmConfig(
        backend="pallas", interpret=True, block_windows=1024,
        chunk_bytes=8192,
    )
    sc = Scanner([pat], 2, cfg)
    got = sc.find(corpus)[0]
    assert list(got) == np_positions(corpus, pat, 2)
    assert len(got) == sc.count(corpus)[0]
