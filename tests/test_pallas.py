"""Triton DP kernel conformance (Pallas interpreter) vs the NumPy oracle.

Interpreter mode is the fake-backend analog of the reference's
``TESTPERFORMANCE_NO_LEVENSHTEIN`` stub (``src/utils.c:77-79``) — except here
it runs the *real* recurrence, so it checks the kernel's arithmetic, tiling
and masking without a GPU. The compiled kernel is checked on the card by
the ``gpu``-marked test at the end and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from apm.models.scanner import Scanner
from apm.ops.common import fold_corpus, round_up
from apm.ops.pallas_kernel import DPStep, dp_count, dp_scan, row_meta
from apm.utils.config import ApmConfig
from apm.utils.io import PatternSet
from apm.utils.oracle import as_u8, banded_distances, count_matches
from tests.conftest import random_dna

INTERPRET = DPStep("pallas", interpret=True)


def pallas_counts(corpus, patterns, k, w=1024):
    """Full scan semantics via the Scanner (device part + host tail)."""
    cfg = ApmConfig(
        backend="pallas",
        interpret=True,
        strategy="single",
        block_windows=w,
    )
    return Scanner(patterns, k, cfg).count(as_u8(corpus)).tolist()


def _table(patterns, k):
    ps = PatternSet.from_patterns(patterns)
    pat, plen = ps.packed(k)
    p_pad = max(8, round_up(ps.num_patterns, 8))
    pat2 = np.zeros((p_pad, pat.shape[1]), np.uint8)
    pat2[: pat.shape[0]] = pat
    plens = tuple(int(x) for x in plen) + (0,) * (p_pad - ps.num_patterns)
    return ps, pat2, plens


def kernel_counts(corpus, patterns, k, wf, bound, start=0, dp=INTERPRET):
    """Raw kernel invocation: untruncated windows in [start, bound) only."""
    ps, pat2, plens = _table(patterns, k)
    buf = as_u8(corpus)
    m_max = ps.max_len
    halo = round_up(m_max, 128)
    nw = max(bound - start, 0)
    n_rows = max(1, -(-nw // wf))
    rows = fold_corpus(buf, start, n_rows, wf, halo)
    out = dp_count(
        jnp.asarray(rows),
        jnp.asarray(pat2),
        jnp.asarray(bound, jnp.int32),
        jnp.asarray(start, jnp.int32),
        k=k,
        m_max=m_max,
        wf=wf,
        plens=plens,
        dp=dp,
    )
    return [int(c) for c in np.asarray(out)[: ps.num_patterns]]


@pytest.mark.parametrize("k", [0, 1, 2, 4])
def test_pallas_random_vs_oracle(k):
    corpus = random_dna(2000, seed=k)
    pats = [random_dna(m, seed=7 * k + m) for m in [1, 3, 8, 33, 50]]
    assert pallas_counts(corpus, pats, k) == count_matches(corpus, pats, k)


def test_pallas_easy():
    assert pallas_counts(b"123123123456456", [b"123", b"456", b"78934"], 0) == [3, 2, 0]


def test_pallas_x100_k0_readme(x100, pattern_20783, pattern_nonexistent):
    pats = [pattern_nonexistent] + [pattern_20783] * 5
    assert pallas_counts(x100, pats, 0, w=8192) == [0, 4, 4, 4, 4, 4]


@pytest.mark.parametrize("k", [0, 1, 3])
def test_pallas_eof_truncation(k):
    """Device bound + host tail must reproduce the EOF truncation quirk."""
    corpus = random_dna(300, seed=99, alphabet=b"AB")
    pats = [random_dna(50, seed=1, alphabet=b"AB"), b"AB"]
    assert pallas_counts(corpus, pats, k) == count_matches(corpus, pats, k)


def test_pallas_block_width_invariance():
    corpus = random_dna(9000, seed=3)
    pats = [random_dna(20, seed=4), random_dna(5, seed=5)]
    want = count_matches(corpus, pats, 2)
    for w in [1024, 2048, 4096]:
        assert pallas_counts(corpus, pats, 2, w=w) == want


def test_pallas_k_exceeds_pattern_len():
    """k >= m: every window within the bound matches."""
    corpus = random_dna(500, seed=8)
    pats = [b"ACG"]
    assert pallas_counts(corpus, pats, 5) == count_matches(corpus, pats, 5)


def test_pallas_corpus_shorter_than_pattern():
    corpus = b"ACGTACGT"
    pats = [random_dna(50, seed=2), b"ACGT"]
    for k in [0, 2]:
        assert pallas_counts(corpus, pats, k) == count_matches(corpus, pats, k)


@pytest.mark.parametrize(
    "wf,tile,bound_cut",
    [
        (128, 128, 0),  # one tile per row
        (256, 128, 1),  # two tiles per row, bound one window short
        (512, 128, 77),  # bound inside a tile
        (512, 256, 200),  # bound inside the second tile
        (384, 128, 128),  # non-power-of-two row: three tiles
        (256, 256, 255),  # bound one window into the last row
    ],
)
def test_kernel_tile_and_bound_masking(wf, tile, bound_cut):
    """Tile edges and the window bound: every tiling of the same rows
    gives the oracle's counts over exactly the windows below the bound,
    per row (the ``dp_scan`` per-row table) and in the mask epilogue."""
    corpus = random_dna(3000, seed=wf + tile + bound_cut)
    pats = [random_dna(m, seed=60 + m) for m in (3, 9, 20)]
    k = 2
    ps, pat2, plens = _table(pats, k)
    m_max = ps.max_len
    bound = len(corpus) - m_max + 1 - bound_cut
    n_rows = -(-bound // wf)
    rows = jnp.asarray(fold_corpus(corpus, 0, n_rows, wf, round_up(m_max, 128)))
    meta = row_meta(n_rows, wf, bound, 0)
    kw = dict(k=k, m_max=m_max, wf=wf, plens=plens, dp=INTERPRET, tile=tile)
    per_row = np.asarray(dp_scan(rows, jnp.asarray(pat2), meta, **kw))
    mask = np.asarray(dp_scan(rows, jnp.asarray(pat2), meta, mask=True, **kw))
    for pi, pb in enumerate(pats):
        hit = banded_distances(corpus, pb, k)[:bound] <= k
        want_rows = np.add.reduceat(
            np.pad(hit, (0, n_rows * wf - bound)).astype(np.int64),
            np.arange(0, n_rows * wf, wf),
        )
        assert per_row[:, pi].tolist() == want_rows.tolist()
        got = mask[:, pi, :].reshape(-1)
        assert np.array_equal(got[:bound].astype(bool), hit)
        assert not got[bound:].any()
    assert not per_row[:, len(pats):].any() and not mask[:, len(pats):].any()


def test_dedup_patterns_expansion():
    """Duplicate patterns share one scan; expanded counts match the oracle."""
    corpus = random_dna(1500, seed=44)
    a, b = random_dna(20, seed=45), random_dna(7, seed=46)
    pats = [a, b, a, a, b]
    for dedup in (True, False):
        cfg = ApmConfig(
            backend="pallas", interpret=True, strategy="single",
            block_windows=1024, dedup_patterns=dedup,
        )
        sc = Scanner(pats, 1, cfg)
        assert sc.count(corpus).tolist() == count_matches(corpus, pats, 1)
        if dedup:
            assert sc.scan_patterns.num_patterns == 2


def test_kernel_start_offset():
    """Global start offset: a tail shard counts exactly its own windows."""
    corpus = random_dna(600, seed=11)
    pats = [random_dna(10, seed=12)]
    k = 1
    start = 256
    bound = len(corpus) - 10 + 1  # untruncated windows only
    dists = banded_distances(corpus, pats[0], k)
    want = int(np.sum(dists[start:bound] <= k))
    assert kernel_counts(corpus, pats, k, wf=128, bound=bound, start=start) == [want]


def test_kernel_shard_decomposition():
    """Two shards with exact ownership must sum to the full device count."""
    corpus = random_dna(4000, seed=21)
    pats = [random_dna(12, seed=22), random_dna(30, seed=23)]
    k = 2
    bound = len(corpus) - 30 + 1
    full = kernel_counts(corpus, pats, k, wf=128, bound=bound, start=0)
    s = 2048  # shard boundary (multiple of FOLD * wf)
    c0 = kernel_counts(corpus, pats, k, wf=128, bound=min(s, bound), start=0)
    c1 = kernel_counts(corpus, pats, k, wf=128, bound=bound, start=s)
    assert [a + b for a, b in zip(c0, c1)] == full


def test_warmup_compiles_then_counts():
    """warmup() pre-compiles the exact shapes the scan will use."""
    corpus = random_dna(5000, seed=71)
    pats = [random_dna(50, seed=72), b"ACG"]
    cfg = ApmConfig(backend="pallas", interpret=True, strategy="single")
    sc = Scanner(pats, 1, cfg)
    sc.warmup(len(corpus))
    assert sc.count(corpus).tolist() == count_matches(corpus, pats, 1)


def test_prewarm_background_thread():
    """prewarm_bytes compiles on a daemon thread; counts stay correct
    whether the scan races the prewarm or waits for it."""
    corpus = random_dna(5000, seed=73)
    pats = [random_dna(50, seed=74), b"ACG"]
    cfg = ApmConfig(
        backend="pallas",
        interpret=True,
        strategy="single",
        prewarm_bytes=len(corpus),
    )
    sc = Scanner(pats, 1, cfg)
    # race the prewarm deliberately: count() must be correct regardless
    racing = sc.count(corpus).tolist()
    assert sc.prewarm_join(timeout=120.0)
    assert racing == count_matches(corpus, pats, 1)
    assert sc.count(corpus).tolist() == count_matches(corpus, pats, 1)


def test_prewarm_join_without_prewarm():
    sc = Scanner([b"ACG"], 0, ApmConfig(backend="xla"))
    assert sc.prewarm_join() is True


def test_jit_cache_collapses_when_myers_off():
    """Pattern sets with identical length multisets but different BYTES
    share one compile whenever the bit-parallel mode is off: the kernel
    reads pattern bytes at run time, and the scanner's DP descriptor drops
    the alphabet from the static key when Myers is off."""
    k = 1  # below the Myers crossover
    wf = 128
    rows = jnp.zeros((2, wf + 128), jnp.uint8)
    meta = row_meta(2, wf, 0, 0)
    steps = set()
    before = dp_scan._cache_size()
    for pat_bytes in (b"GATTACA!", b"CCCTTTAA"):
        sc = Scanner([pat_bytes], k, ApmConfig(backend="pallas", interpret=True))
        steps.add(sc.dp_step())
        dp_scan(
            rows, jnp.asarray(sc._pat), meta, k=k, m_max=8, wf=wf,
            plens=sc._plens_static, dp=sc.dp_step(),
        )
    assert steps == {INTERPRET}
    assert dp_scan._cache_size() == before + 1
    # With the mode ON, dp_impl "auto" and "myers" resolve to one key.
    k = 6
    keys = {
        Scanner(
            [b"GATTACAGGATTACAG"], k,
            ApmConfig(backend="pallas", interpret=True, dp_impl=impl),
        ).dp_step()
        for impl in ("auto", "myers")
    }
    assert keys == {DPStep("pallas", True, (65, 67, 71, 84))}


@pytest.mark.parametrize("k", [0, 1, 3, 6, 14])
def test_kernel_matches_xla_band(k):
    """The interpreted kernel (band, and Myers where representable) and
    the plain XLA band agree per row and per window on the same staged
    rows, with a ragged per-row bound table."""
    corpus = random_dna(4096, seed=80 + k)
    pats = [bytes(corpus[100:120]), random_dna(33, seed=81), b"ACGTA"]
    ps, pat2, plens = _table(pats, k)
    m_max, wf = ps.max_len, 256
    rows = jnp.asarray(
        fold_corpus(corpus, 0, 12, wf, round_up(m_max + 2 * k, 128))
    )
    starts = np.arange(12) * wf
    meta = jnp.asarray(
        np.stack([starts + (np.arange(12) * 53) % wf, starts], 1), jnp.int32
    )
    kw = dict(k=k, m_max=m_max, wf=wf, plens=plens)
    ref = np.asarray(dp_scan(rows, jnp.asarray(pat2), meta, dp=DPStep("xla"), **kw))
    ref_mask = np.asarray(
        dp_scan(rows, jnp.asarray(pat2), meta, dp=DPStep("xla"), mask=True, **kw)
    )
    assert ref.sum() > 0
    alph = tuple(sorted({int(b) for p in pats for b in p}))
    steps = [INTERPRET]
    if 1 <= k <= 14:
        steps.append(DPStep("pallas", True, alph))
    for dp in steps:
        got = np.asarray(dp_scan(rows, jnp.asarray(pat2), meta, dp=dp, **kw))
        mask = np.asarray(
            dp_scan(rows, jnp.asarray(pat2), meta, dp=dp, mask=True, **kw)
        )
        assert np.array_equal(got, ref), dp
        assert np.array_equal(mask, ref_mask), dp


@pytest.mark.gpu
def test_compiled_kernel_matches_oracle(gpu):
    """The compiled Triton kernel (no interpreter) on the card."""
    corpus = random_dna(200_000, seed=5)
    pats = [random_dna(m, seed=m) for m in (12, 33, 50)]
    bound = len(corpus) - 50 + 1
    want = [
        int(np.sum(banded_distances(corpus, p, 2)[:bound] <= 2)) for p in pats
    ]
    got = kernel_counts(corpus, pats, 2, wf=8192, bound=bound, dp=DPStep("pallas"))
    assert got == want
