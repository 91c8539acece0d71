"""Device-corpus cache correctness: full-content keys and byte bounds.

Round 1's sampling fingerprint (~192 bytes) could serve stale device rows
after a localized in-place mutation and the LRU was capped
by entry count, not bytes. These tests pin the fixes.
"""

import numpy as np
import pytest

from apm.models.scanner import Scanner
from apm.utils.config import ApmConfig
from apm.utils.oracle import count_matches
from tests.conftest import random_dna

PALLAS = dict(backend="pallas", interpret=True, block_windows=1024)


def test_inplace_mutation_invalidates_cache():
    """Mutate one byte between two count() calls on the SAME buffer — a
    spot the round-1 sampling scheme never read. The second scan must see
    the new content."""
    data = random_dna(100_000, seed=7)
    pat = bytes(data[5000:5030].tobytes())  # exact match at 5000
    sc = Scanner([pat], 0, ApmConfig(engine="dp", **PALLAS))
    before = sc.count(data).tolist()
    assert before == count_matches(data, [pat], 0)
    # kill the match with a single-byte edit off the old sample stride
    data[5011] ^= 0xFF
    after = sc.count(data).tolist()
    assert after == count_matches(data, [pat], 0)
    assert after != before


def test_second_corpus_same_length_not_conflated():
    data1 = random_dna(50_000, seed=8)
    data2 = data1.copy()
    data2[30_001] ^= 1  # differs in one mid-stride byte
    pat = bytes(data1[30_000:30_020].tobytes())
    sc = Scanner([pat], 0, ApmConfig(engine="dp", **PALLAS))
    c1 = sc.count(data1).tolist()
    c2 = sc.count(data2).tolist()
    assert c1 == count_matches(data1, [pat], 0)
    assert c2 == count_matches(data2, [pat], 0)


def test_cache_byte_budget_evicts():
    """With a tiny byte budget the cache never holds more than fits."""
    cfg = ApmConfig(cache_bytes=1 << 20, **PALLAS)
    sc = Scanner([b"ACGTACGTAC"], 0, cfg)
    for seed in range(4):
        sc.count(random_dna(600_000, seed=100 + seed))
    total = sum(v.nbytes for v in sc._dev_cache.values())
    assert total <= (1 << 20) or len(sc._dev_cache) <= 1


def test_fingerprint_full_content():
    buf = random_dna(10_000, seed=9)
    fp1 = Scanner._fingerprint(buf)
    buf2 = buf.copy()
    buf2[4321] ^= 2
    assert Scanner._fingerprint(buf2) != fp1
    assert Scanner._fingerprint(buf.copy()) == fp1


def test_corpus_fp_memoizes_immutable_only():
    """Immutable buffers hash once (memoized by identity); writable
    buffers re-hash every call; read-only VIEWS of writable bases do NOT
    memoize (the base can still mutate the bytes)."""
    sc = Scanner([b"ACGTACGTAC"], 0, ApmConfig(**PALLAS))
    frozen = random_dna(20_000, seed=11)
    frozen.setflags(write=False)
    fp1 = sc._corpus_fp(frozen)
    assert fp1 == sc._corpus_fp(frozen)
    assert id(frozen) in sc._fp_memo
    # writable: never memoized
    mut = random_dna(20_000, seed=12)
    sc._corpus_fp(mut)
    assert id(mut) not in sc._fp_memo
    # read-only view of a writable base: not immutable
    view = mut[:]
    view.setflags(write=False)
    assert not Scanner._immutable(view)
    sc._corpus_fp(view)
    assert id(view) not in sc._fp_memo
    # memmap / frombuffer style arrays qualify
    fb = np.frombuffer(bytes(random_dna(1000, seed=13)), dtype=np.uint8)
    assert Scanner._immutable(fb)
    # dead arrays are evicted via the weakref callback
    import gc

    key = id(frozen)
    del frozen, fp1
    gc.collect()
    assert key not in sc._fp_memo


def test_count_correct_after_freezing_and_new_buffer():
    """End-to-end: scans on a frozen buffer and a same-shape successor
    (possibly recycling the id) stay content-correct."""
    pat = b"TTTTTTTTTTGG"
    sc = Scanner([pat], 0, ApmConfig(engine="dp", **PALLAS))
    a = random_dna(30_000, seed=14).copy()
    a[100 : 100 + len(pat)] = np.frombuffer(pat, np.uint8)
    a.setflags(write=False)
    assert sc.count(a).tolist() == count_matches(a, [pat], 0)
    b = random_dna(30_000, seed=15)
    b.setflags(write=False)
    assert sc.count(b).tolist() == count_matches(b, [pat], 0)


def test_warmup_purge_scoped_to_zero_corpus():
    """warmup() may run on the background prewarm thread concurrently
    with real scans — its cache purge must remove only the zero-corpus
    entries it staged, never the foreground corpus's device staging or
    its memoized fingerprint (round-4 review: the snapshot-diff purge
    evicted concurrent foreground keys, and _fp_memo.clear() dropped
    every memoized fingerprint)."""
    pat = b"ACGTACGTAC"
    # single-device: the sharded paths stage per-shard and don't use the
    # device-corpus cache this test inspects
    sc = Scanner([pat], 0, ApmConfig(strategy="single", **PALLAS))
    real = random_dna(20_000, seed=21)
    real.setflags(write=False)
    want = count_matches(real, [pat], 0)
    assert sc.count(real).tolist() == want
    keys_before = set(sc._dev_cache)
    assert keys_before
    assert id(real) in sc._fp_memo
    sc.warmup(20_000)
    # the real corpus's staging and memoized fingerprint survive
    assert keys_before <= set(sc._dev_cache)
    assert id(real) in sc._fp_memo
    # ... and no zero-corpus entry lingers in either cache
    zfp = Scanner._fingerprint(np.zeros(20_000, np.uint8))
    assert all(k[0] != zfp for k in sc._dev_cache)
    assert sc.count(real).tolist() == want


def test_as_u8_multi_element_string_array_rejected():
    from apm.utils.oracle import as_u8

    with pytest.raises(ValueError):
        as_u8(np.array(["AC", "GT"]))
    with pytest.raises(ValueError):
        as_u8(np.array([b"AC", b"GT"]))
    # scalars / single elements stay supported, without NUL padding
    assert as_u8(np.array("ACGT")).tobytes() == b"ACGT"
    assert as_u8(np.array([b"AC"], dtype="S4")).tobytes() == b"AC"
    assert as_u8(np.array([], dtype="U4")).size == 0
