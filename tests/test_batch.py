"""Batched serving API: count_batch == per-corpus count, one dispatch."""

import numpy as np
import pytest

from apm.models.scanner import Scanner
from apm.utils.config import ApmConfig
from apm.utils.oracle import count_matches
from tests.conftest import random_dna

PALLAS = dict(backend="pallas", interpret=True, block_windows=1024)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_count_batch_matches_oracle(k):
    from apm.utils.corpus import plant, random_pattern

    pats = [random_pattern(20, seed=401), random_pattern(33, seed=402),
            random_pattern(20, seed=401)]  # duplicate exercises dedup
    corpora = [
        random_dna(700, seed=410),   # smaller than one block
        random_dna(9000, seed=411),  # several blocks
        random_dna(15, seed=412),    # tail-only (shorter than m_max)
        np.zeros((0,), np.uint8),    # empty
        random_dna(4096, seed=413),
    ]
    if k > 0:
        plant(corpora[1], np.asarray(pats[0]), [100, 5000], k=k, seed=414)
    sc = Scanner(pats, k, ApmConfig(**PALLAS))
    got = sc.count_batch(corpora)
    assert got.shape == (5, 3)
    for b, corpus in enumerate(corpora):
        want = count_matches(corpus, pats, k)
        assert got[b].tolist() == want, (b, got[b].tolist(), want)
        assert got[b].tolist() == sc.count(corpus).tolist()


@pytest.mark.parametrize("engine", ["auto", "corr", "dp"])
def test_count_batch_corr_engine(engine):
    """k = 0 batches route the correlation engine (auto/corr) and the
    counts stay oracle-exact and engine-invariant."""
    from apm.utils.corpus import random_pattern

    pats = [random_pattern(50, seed=440 + i) for i in range(9)]
    pats.append(pats[0])  # duplicate exercises dedup
    corpora = [
        random_dna(700, seed=450),
        random_dna(9000, seed=451).copy(),  # several blocks
        random_dna(30, seed=452),  # tail-only
        np.zeros((0,), np.uint8),
        random_dna(4096, seed=453).copy(),
    ]
    # plant exact occurrences, including one straddling a block boundary
    corpora[1][100:150] = np.asarray(pats[0])
    corpora[1][1020:1070] = np.asarray(pats[3])
    corpora[4][4040:4090] = np.asarray(pats[5])
    sc = Scanner(pats, 0, ApmConfig(engine=engine, **PALLAS))
    got = sc.count_batch(corpora)
    for b, corpus in enumerate(corpora):
        want = count_matches(corpus, pats, 0)
        assert got[b].tolist() == want, (engine, b, got[b].tolist(), want)
        assert got[b].tolist() == sc.count(corpus).tolist()


def test_count_batch_multiple_groups():
    """More blocks than one group bucket: grouping must not change counts."""
    pats = [b"ACGTACGTAC"]
    corpora = [random_dna(3000, seed=420 + i) for i in range(6)]
    cfg = ApmConfig(chunk_bytes=1 << 16, **PALLAS)  # tiny groups
    sc = Scanner(pats, 1, cfg)
    got = sc.count_batch(corpora)
    for b, corpus in enumerate(corpora):
        assert got[b].tolist() == count_matches(corpus, pats, 1)


def test_count_batch_xla_backend_fallback():
    """backend="xla" runs the same batched path with the plain XLA band
    as its DP step (no per-corpus count() loop)."""
    pats = [b"GATTACA"]
    corpora = [random_dna(2000, seed=430), random_dna(100, seed=431)]
    sc = Scanner(pats, 1, ApmConfig(backend="xla", block_windows=1024))
    got = sc.count_batch(corpora)
    for b, corpus in enumerate(corpora):
        assert got[b].tolist() == count_matches(corpus, pats, 1)


# -- count_stream -----------------------------------------------------------


def _split_stream(buf, sizes, rng):
    """Yield buf in chunks of pseudo-random sizes (covers empty chunks)."""
    i = 0
    while i < len(buf):
        s = int(sizes[int(rng.integers(0, len(sizes)))])
        yield bytes(buf[i : i + s])
        i += s
        if int(rng.integers(0, 4)) == 0:
            yield b""  # empty chunks must be harmless


@pytest.mark.parametrize("k", [0, 1, 2])
def test_count_stream_matches_count(k):
    """count_stream == count(concatenation) across chunkings, incl. match
    windows straddling every segment boundary."""
    rng = np.random.default_rng(40 + k)
    corpus = random_dna(9000, seed=70 + k).copy()
    pat = random_dna(50, seed=71)
    short = random_dna(7, seed=72)
    # plant matches straddling the segment boundaries the stream will cut
    for pos in [480, 990, 1490, 2990, 5990, 8940]:
        corpus[pos : pos + 50] = pat
    cfg = ApmConfig(
        backend="pallas", interpret=True, strategy="single",
        block_windows=1024,
    )
    sc = Scanner([pat, short, pat], k, cfg)
    want = sc.count(corpus)
    got = sc.count_stream(
        _split_stream(corpus, [1, 37, 256, 1000], rng),
        segment_bytes=500,
    )
    assert got.tolist() == want.tolist()
    assert want.tolist() == count_matches(corpus, [pat, short, pat], k)


def test_count_stream_xla_backend():
    rng = np.random.default_rng(5)
    corpus = random_dna(4000, seed=80)
    pats = [random_dna(33, seed=81), random_dna(12, seed=82)]
    cfg = ApmConfig(backend="xla", strategy="single", block_windows=1024)
    sc = Scanner(pats, 1, cfg)
    got = sc.count_stream(_split_stream(corpus, [513, 64], rng),
                          segment_bytes=700)
    assert got.tolist() == count_matches(corpus, pats, 1)


def test_count_stream_tiny_and_empty():
    cfg = ApmConfig(backend="xla", strategy="single", block_windows=1024)
    sc = Scanner([b"ACG"], 1, cfg)
    assert sc.count_stream(iter([])).tolist() == [0]
    assert sc.count_stream(iter([b""])).tolist() == [0]
    # stream shorter than one pattern: pure EOF-truncation territory
    got = sc.count_stream(iter([b"AC"]))
    assert got.tolist() == count_matches(b"AC", [b"ACG"], 1)


def test_count_batch_corr_ineligible_raises():
    """Forced engine='corr' raises on an ineligible batch instead of
    silently routing to the banded DP — the same contract count()
    implements."""
    wide = bytes(range(40))  # alphabet 40 > ALPHABET_MAX
    sc = Scanner([wide], 0, ApmConfig(engine="corr", **PALLAS))
    with pytest.raises(ValueError, match="corr"):
        sc.count_batch([random_dna(2000, seed=420)])


def test_fp_memo_detects_refrozen_mutation():
    """A frozen buffer thawed, mutated in place, and re-frozen must not be
    served stale cached counts via the fingerprint memo.

    The memo's guard is a 9-offset byte sample (`Scanner._fp_sample`), so
    the mutation here targets the sampled head of the buffer; strategy is
    forced single-device because the sharded paths stage per-shard and
    don't consult the memo."""
    pat = random_dna(12, seed=430).tobytes()
    corpus = random_dna(4000, seed=431)
    corpus[20:32] = np.frombuffer(pat, np.uint8)
    corpus.setflags(write=False)
    sc = Scanner([pat], 0, ApmConfig(strategy="single", **PALLAS))
    first = sc.count(corpus).tolist()
    assert first == count_matches(corpus, [pat], 0)
    assert len(sc._fp_memo) == 1  # the memo path is actually engaged
    corpus.setflags(write=True)
    corpus[20:32] = 0  # kill the planted occurrence in place
    corpus.setflags(write=False)
    assert sc.count(corpus).tolist() == count_matches(corpus, [pat], 0)


def test_warmup_covers_serving_paths():
    """After Scanner.warmup(n), the first find() and count_batch() on an
    n-byte corpus must add NO new jit-cache entries — the serving paths
    compile nothing at first request."""
    import apm.ops.fused as fused
    import apm.ops.pallas_kernel as pk
    from apm.utils.corpus import random_pattern

    n = 20000
    pats = [random_pattern(50, seed=501), random_pattern(8, seed=502)]
    cfg = ApmConfig(strategy="single", **PALLAS)
    sc = Scanner(pats, 2, cfg)
    sc.warmup(n)
    tracked = [
        fused.sweep_positions_chunk,
        fused.gather_mask_rows,
        fused.filter_verify_chunk_conv,
        pk.dp_scan,
    ]
    before = [f._cache_size() for f in tracked]
    corpus = random_dna(n, seed=503)
    sc.find(corpus)
    sc.count_batch([corpus])
    after = [f._cache_size() for f in tracked]
    assert after == before, (before, after)


def test_warmup_leaves_corpus_caches_clean():
    """The zero corpus driven through find()/count_batch during warmup
    must not occupy the device-corpus or fingerprint caches."""
    cfg = ApmConfig(strategy="single", **PALLAS)
    sc = Scanner([random_dna(20, seed=504).tobytes()], 1, cfg)
    sc.warmup(8000)
    assert sc._dev_cache == {}
    assert sc._fp_memo == {}
