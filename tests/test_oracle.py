"""Golden-oracle tests: the two independent NumPy oracles against hand counts
and against each other. Everything downstream is measured against these.
"""

import numpy as np
import pytest

from apm.utils.oracle import (
    banded_distances,
    count_matches,
    count_matches_reference,
    levenshtein_square,
)
from tests.conftest import random_dna


def test_levenshtein_square_basics():
    assert levenshtein_square(b"abc", b"abc") == 0
    assert levenshtein_square(b"abc", b"abd") == 1
    assert levenshtein_square(b"abc", b"bcd") == 2  # shift by one: del+ins
    assert levenshtein_square(b"aaa", b"bbb") == 3
    assert levenshtein_square(b"", b"") == 0


def test_easy_fa_hand_counts():
    # dna/easy.fa = "123123123456456"; scripts/run_tests:30-34 fixture.
    corpus = b"123123123456456"
    assert count_matches(corpus, [b"123", b"456", b"78934"], 0) == [3, 2, 0]
    assert count_matches_reference(corpus, [b"123", b"456", b"78934"], 0) == [3, 2, 0]


def test_easy_fa_file(easy_fa):
    assert count_matches(easy_fa, [b"123", b"456", b"78934"], 0) == [3, 2, 0]


def test_x100_readme_counts(x100, pattern_20783, pattern_nonexistent):
    # README.md:54-91 / scripts/basic_test.batch conformance workload.
    pats = [pattern_nonexistent] + [pattern_20783] * 5
    assert count_matches(x100, pats, 0) == [0, 4, 4, 4, 4, 4]


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4])
def test_banded_equals_square_random(k):
    """Property: clamped banded distance == min(square distance, k+1)."""
    rng = np.random.default_rng(100 + k)
    corpus = random_dna(80, seed=7 + k, alphabet=b"AC")
    for m in [1, 2, 3, 5, 8]:
        pat = random_dna(m, seed=50 + m + k, alphabet=b"AC")
        dists = banded_distances(corpus, pat, k)
        n = len(corpus)
        for j in range(n - k):
            size = min(m, n - j)
            true = levenshtein_square(pat[:size], corpus[j : j + size])
            assert dists[j] == min(true, k + 1), (k, m, j)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_fast_vs_slow_oracle(k):
    corpus = random_dna(60, seed=k, alphabet=b"ACGT")
    pats = [random_dna(m, seed=10 * k + m) for m in [1, 4, 7]]
    assert count_matches(corpus, pats, k) == count_matches_reference(corpus, pats, k)


def test_eof_truncation_quirk():
    """Windows near EOF compare pattern *prefixes* (sequential.c:131-134).

    Corpus "XXAB" with pattern "ABC", k=0: window j=2 has size=2 and compares
    "AB" vs "AB" -> distance 0 -> counted, even though "ABC" never occurs.
    """
    assert count_matches(b"XXAB", [b"ABC"], 0) == [1]
    assert count_matches_reference(b"XXAB", [b"ABC"], 0) == [1]


def test_window_bound_subtracts_k_not_m():
    """The loop bound is n - k (sequential.c:121), independent of m."""
    # n=4, k=2 -> windows j in {0,1}; pattern "ZZZ" vs "AAAA".
    # j=0: lev("ZZZ","AAA")=3 > 2; j=1: size=3, lev("ZZZ","AAA")=3 > 2.
    assert count_matches_reference(b"AAAA", [b"ZZZ"], 2) == [0]
    assert count_matches(b"AAAA", [b"ZZZ"], 2) == [0]
    # Pattern "AAZ": j=0 lev("AAZ","AAA")=1<=2 ok; j=1 same -> 2 matches.
    assert count_matches(b"AAAA", [b"AAZ"], 2) == [2]


def test_k_ge_n_zero_windows():
    assert count_matches(b"AB", [b"AB"], 2) == [0]
    assert count_matches(b"AB", [b"AB"], 5) == [0]
    assert count_matches_reference(b"AB", [b"AB"], 5) == [0]


def test_k_larger_than_pattern():
    # Every window with size <= k trivially matches (distance <= size <= k),
    # and truncated sizes are always > k... actually size >= k+1 in-loop.
    corpus = b"ABCDEFGH"
    got = count_matches(corpus, [b"XY"], 3)
    want = count_matches_reference(corpus, [b"XY"], 3)
    assert got == want


def test_single_byte_corpus_and_pattern():
    assert count_matches(b"A", [b"A"], 0) == [1]
    assert count_matches(b"B", [b"A"], 0) == [0]
    assert count_matches(b"B", [b"A"], 1) == [0]  # n-k = 0 windows


# -- corpus generator utilities ----------------------------------------------


def test_corpus_generator_plants():
    from apm.utils.corpus import (
        boundary_straddling_corpus,
        mutate,
        plant,
        random_corpus,
        random_pattern,
    )
    from apm.utils.oracle import count_matches

    pat = random_pattern(20, seed=1)
    corpus = random_corpus(2000, seed=2)
    plant(corpus, pat, [100, 700, 1500], k=0)
    assert count_matches(corpus, [pat], 0)[0] >= 3

    w = mutate(pat, 2, seed=3)
    assert abs(len(w) - len(pat)) <= 2

    corpus2, positions = boundary_straddling_corpus(4000, pat, 512, k=1, seed=4)
    assert len(positions) >= 6
    assert count_matches(corpus2, [pat], 1)[0] >= len(positions) - 1


def test_profiling_utilities():
    import os
    import tempfile

    from apm.utils.profiling import Meter, ScanStats, Stopwatch, trace

    s = ScanStats(
        corpus_bytes=1_000_000, patterns=6, unique_patterns=2, k=0,
        strategy="single", backend="pallas", block_windows=32768,
        seconds=0.001,
    )
    assert abs(s.mb_per_s - 1000.0) < 1e-6
    assert "1000000 B" in s.line()
    m = Meter()
    m.record(s)
    m.record(s)
    assert m.total_bytes == 2_000_000
    assert m.aggregate_mb_per_s > 0
    sw = Stopwatch()
    sw.lap("phase1")
    assert sw.laps[0][0] == "phase1"
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            pass  # a real jax trace start/stop cycle
        assert os.listdir(d)  # trace files were written


def test_reference_shaped_corpus():
    """The seeded stand-in for the reference's .fa files: 50-byte ACGT
    lines, an absent 32-byte pattern, and plants where it says."""
    from apm.utils.corpus import FA_LINE, reference_shaped

    corpus, line, absent, plants = reference_shaped(
        40_000, seed=3, exact=3, fuzzy=2
    )
    assert len(line) == FA_LINE and len(absent) == 32
    assert set(np.unique(corpus).tobytes()) <= set(b"ACGT\n")
    assert (corpus[FA_LINE - 1 :: FA_LINE] == ord("\n")).all()
    assert [s for _, s in plants].count(0) == 3
    assert count_matches(corpus, [absent, line], 0) == [0, 3]
    for pos, subs in plants:
        assert int(banded_distances(corpus[pos : pos + FA_LINE], line, 2)[0]) == subs
    again = reference_shaped(40_000, seed=3, exact=3, fuzzy=2)
    assert np.array_equal(again[0], corpus) and again[3] == plants
