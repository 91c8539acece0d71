"""Conformance + gating tests for the correlation engines
(apm.ops.corr_engine): the ±1 bit-plane conv == exact-match counts at
k = 0, and the piece conv as filtration phase 1 at k >= 1, bit-for-bit
with the oracle like every other engine."""

import numpy as np
import pytest

from apm import Scanner
from apm.models.pipeline import make_plan
from apm.utils.config import ApmConfig
from apm.utils.corpus import plant, random_corpus, random_pattern
from apm.utils.oracle import count_matches

from conftest import random_dna


def _cfg(**kw):
    kw.setdefault("backend", "pallas")
    kw.setdefault("interpret", True)
    kw.setdefault("strategy", "single")
    return ApmConfig(**kw)


def test_engine_selection_and_forcing():
    corpus = random_corpus(20000, seed=1)
    # Above the measured auto crossover (sum of distinct pattern bytes >=
    # AUTO_MIN_WORK) auto routes corr; below it the banded kernel wins.
    big = [bytes(random_pattern(50, seed=s)) for s in range(10)]
    sc = Scanner(big, 0, _cfg(engine="auto"))
    assert make_plan(sc, len(corpus)).engine == "corr"
    small = [b"ACGT", b"GATTACA"]
    sc = Scanner(small, 0, _cfg(engine="auto"))
    assert not make_plan(sc, len(corpus)).use_corr
    # one long pattern is enough: the banded chain scales with m_max
    long1 = [bytes(random_pattern(60, seed=99))]
    sc = Scanner(long1, 0, _cfg(engine="auto"))
    assert make_plan(sc, len(corpus)).use_corr
    sc = Scanner(small, 0, _cfg(engine="corr"))  # forced: any size
    assert make_plan(sc, len(corpus)).use_corr
    sc = Scanner(big, 0, _cfg(engine="dp"))
    assert make_plan(sc, len(corpus)).engine == "dp"
    # k >= 1 never routes corr
    sc = Scanner(big, 1, _cfg(engine="auto"))
    assert not make_plan(sc, len(corpus)).use_corr


@pytest.mark.parametrize("seed", [0, 7])
def test_corr_matches_oracle_mixed_lengths(seed):
    corpus = random_corpus(250000, seed=seed)
    pats = [
        b"A",  # single byte: below the filter engine's eligibility, fine here
        b"ACGT",
        bytes(random_pattern(50, seed=seed + 1)),
        bytes(random_pattern(200, seed=seed + 2)),  # absent long pattern
        b"ACGT",  # duplicate
    ]
    plant(corpus, np.frombuffer(b"ACGTACGTACGT", np.uint8), [17, 5000], k=0)
    exp = count_matches(corpus, pats, 0)
    got = Scanner(pats, 0, _cfg(engine="corr")).count(corpus).tolist()
    assert got == exp
    # and against the other engines: the kernel and the plain XLA band
    assert Scanner(pats, 0, _cfg(engine="dp")).count(corpus).tolist() == exp
    xla = _cfg(engine="dp", backend="xla", interpret=False)
    assert Scanner(pats, 0, xla).count(corpus).tolist() == exp


def test_corr_chunked_and_cached():
    """Multiple chunks + the device corpus cache reuse staged rows."""
    corpus = random_corpus(400000, seed=3)
    pats = [b"ACGTT", bytes(random_pattern(33, seed=4))]
    cfg = _cfg(engine="corr", chunk_bytes=1 << 17, cache_corpus=True)
    sc = Scanner(pats, 0, cfg)
    exp = count_matches(corpus, pats, 0)
    assert sc.count(corpus).tolist() == exp
    assert sc.count(corpus).tolist() == exp  # cached rows second time


def test_corr_eof_tail_and_tiny_corpus():
    pats = [b"TTTT", b"GG"]
    for n in (1, 3, 4, 5, 64):
        corpus = np.frombuffer(b"TTTTGGTT" * 8, np.uint8)[:n].copy()
        exp = count_matches(corpus, pats, 0)
        got = Scanner(pats, 0, _cfg(engine="corr")).count(corpus).tolist()
        assert got == exp, (n, got, exp)


def test_corr_sharded_database_strategy():
    corpus = random_corpus(300000, seed=9)
    pats = [b"ACGTACGT", b"CA", bytes(random_pattern(64, seed=10))]
    exp = count_matches(corpus, pats, 0)
    cfg = _cfg(engine="corr", strategy="database_over_devices")
    sc = Scanner(pats, 0, cfg)
    assert sc.count(corpus).tolist() == exp
    assert make_plan(sc, len(corpus)).use_corr


def test_corr_binary_safe_alphabet():
    """NUL/0xFF bytes are ordinary channels."""
    rng = np.random.default_rng(11)
    corpus = rng.integers(0, 256, size=60000).astype(np.uint8)
    pats = [bytes([0, 255, 0]), bytes(corpus[100:140]), b"\x00"]
    exp = count_matches(corpus, pats, 0)
    # alphabet here is large (random 40-byte pattern) -> auto must fall
    # back and still match; a small-alphabet subset must route corr.
    got = Scanner(pats, 0, _cfg(engine="auto")).count(corpus).tolist()
    assert got == exp
    small = [bytes([0, 255, 0]), b"\x00", bytes([255, 255])]
    sc = Scanner(small, 0, _cfg(engine="corr"))
    assert sc.count(corpus).tolist() == count_matches(corpus, small, 0)


def test_corr_ineligible_raises_and_auto_falls_back():
    corpus = random_corpus(10000, seed=12)
    wide = bytes(range(40))  # alphabet 40 > ALPHABET_MAX
    with pytest.raises(ValueError, match="corr"):
        Scanner([wide], 0, _cfg(engine="corr")).count(corpus)
    with pytest.raises(ValueError, match="corr"):
        Scanner([b"ACGT"], 1, _cfg(engine="corr")).count(corpus)
    long = bytes(random_pattern(600, seed=13))  # m_max 600 > M_MAX_CORR
    with pytest.raises(ValueError, match="corr"):
        Scanner([long], 0, _cfg(engine="corr")).count(corpus)
    # auto silently falls back for all three
    for pats in ([wide], [long], [b"ACGT"]):
        k = 0
        got = Scanner(pats, k, _cfg(engine="auto")).count(corpus).tolist()
        assert got == count_matches(corpus, pats, k)


def test_corr_dense_matches():
    """Every window hot (single-byte pattern on a one-letter corpus):
    no filtration machinery involved, counts stay exact."""
    corpus = np.full(50000, ord("A"), dtype=np.uint8)
    pats = [b"A", b"AAAA", b"AT"]
    exp = count_matches(corpus, pats, 0)
    got = Scanner(pats, 0, _cfg(engine="corr")).count(corpus).tolist()
    assert got == exp


# -- conv phase 1 for k >= 1 filtration ---------------------------------------


def test_fp1_conv_plan_gating():
    """Filtration takes exactly the exact-tier, long-piece patterns of an
    above-crossover set; everything else runs the banded DP."""
    n = 300000
    pats = [bytes(random_pattern(120, seed=s)) for s in range(3)]
    plan = make_plan(Scanner(pats, 1, _cfg(engine="auto")), n)
    assert plan.any_filter and not plan.any_dp
    # engine="dp" pins the banded DP for every pattern
    sc = Scanner(pats, 1, _cfg(engine="dp"))
    assert not make_plan(sc, n).any_filter
    # a short-piece pattern (m=18, k=1 -> 9-byte pieces < FP1_LMIN) runs
    # the banded DP; the long ones stay filtered
    mixed = pats + [bytes(random_pattern(18, seed=9))]
    plan = make_plan(Scanner(mixed, 1, _cfg(engine="auto")), n)
    assert plan.fmask == (True, True, True, False) + (False,) * 4
    assert plan.plens_dp[3] == 18
    # k=0 is the corr engine's territory, never filtration
    sc = Scanner(pats, 0, _cfg(engine="auto"))
    assert not make_plan(sc, n).any_filter
    # banded-tier patterns (one-error pieces) cannot run on a correlation
    sc = Scanner([bytes(random_pattern(90, seed=10))], 6, _cfg(engine="auto"))
    plan6 = make_plan(sc, n)
    assert not plan6.any_filter and plan6.any_dp
    # wide alphabets have no channel budget
    wide = [bytes(range(64, 64 + 30)) + bytes(random_pattern(90, seed=11))]
    sc = Scanner(wide, 1, _cfg(engine="auto"))
    assert not make_plan(sc, n).any_filter
    # below the crossover (short set) filtration does not pay
    sc = Scanner([bytes(random_pattern(30, seed=12))], 1, _cfg(engine="auto"))
    assert not make_plan(sc, n).any_filter


@pytest.mark.parametrize("k", [1, 2, 4])
def test_fp1_conv_matches_oracle(k):
    """Conv phase 1 + shared device verification == oracle == the banded
    DP over every window, with planted k-error matches."""
    corpus = random_corpus(60000, seed=50 + k)
    pats = [
        bytes(random_pattern(120, seed=60 + k)),
        bytes(random_pattern(75, seed=70 + k)),
    ]
    for i, p in enumerate(pats):
        plant(
            corpus, np.frombuffer(p, np.uint8),
            [500 + 7000 * i, 30000 + 128 * i, 59000], k=k, seed=80 + k + i,
        )
    sc = Scanner(pats, k, _cfg(engine="auto"))
    assert make_plan(sc, len(corpus)).any_filter
    exp = count_matches(corpus, pats, k)
    assert sum(exp) >= 4
    assert sc.count(corpus).tolist() == exp
    got_dp = Scanner(pats, k, _cfg(engine="dp")).count(corpus).tolist()
    assert got_dp == exp


def test_fp1_conv_dense_overflow_recovery():
    """Low-entropy corpus floods the row maps: the shared phase 2 must
    recover (hot-row overflow / density fallback) with exact counts."""
    corpus = np.full(40000, ord("A"), dtype=np.uint8)
    pats = [b"A" * 108 + b"C" * 12]  # fp1-eligible, every row goes hot
    sc = Scanner(pats, 1, _cfg(engine="auto"))
    assert make_plan(sc, len(corpus)).any_filter
    exp = count_matches(corpus, pats, 1)
    assert sc.count(corpus).tolist() == exp


def test_fp1_conv_sharded_and_multihost():
    """Conv phase 1 through database_over_devices and count_multihost."""
    import os
    import tempfile

    import jax

    from apm.parallel.multihost import count_multihost

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    k = 1
    corpus = random_corpus(90000, seed=90)
    pats = [bytes(random_pattern(120, seed=91)),
            bytes(random_pattern(64, seed=92))]
    for i, p in enumerate(pats):
        plant(
            corpus, np.frombuffer(p, np.uint8),
            [1000 + 13000 * i, 44000 + 128 * i, 88000], k=k, seed=93 + i,
        )
    exp = count_matches(corpus, pats, k)
    assert sum(exp) >= 6
    cfg = _cfg(engine="auto", strategy="database_over_devices")
    sc = Scanner(pats, k, cfg)
    assert make_plan(sc, len(corpus)).any_filter
    assert sc.count(corpus).tolist() == exp
    with tempfile.NamedTemporaryFile(suffix=".fa", delete=False) as f:
        f.write(corpus.tobytes())
        path = f.name
    try:
        sc2 = Scanner(pats, k, _cfg(engine="auto"))
        got = [int(c) for c in count_multihost(sc2, path)[: len(pats)]]
        assert got == exp
    finally:
        os.unlink(path)


def test_corr_group_padding_boundary():
    """Row count not divisible by the group size exercises the group-pad
    mask (windows past n_rows must not count)."""
    from apm.ops.corr_engine import _group_rows, build_alphabet, build_kernel, scan_corr_conv
    import jax.numpy as jnp

    corpus = random_corpus(9000, seed=14)
    pats = [b"ACG"]
    m_max = 3
    wf, halo = 256, 128
    bound = len(corpus) - m_max + 1
    n_rows = -(-bound // wf)
    rows = np.zeros((n_rows, wf + halo), np.uint8)
    for r in range(n_rows):
        seg = corpus[r * wf : r * wf + wf + halo]
        rows[r, : len(seg)] = seg
    pat_raw = np.frombuffer(b"ACG", np.uint8)[None, :]
    alph = build_alphabet(pats)
    kern, thr = build_kernel(pat_raw, (3,), alph)
    for g_rows in (7, 8, n_rows):  # 7 does not divide n_rows
        got = np.asarray(
            scan_corr_conv(
                jnp.asarray(rows), jnp.asarray(kern), jnp.asarray(thr),
                jnp.asarray(alph),
                jnp.asarray(bound, jnp.int32), jnp.asarray(0, jnp.int32),
                wf=wf, m_max=m_max, n_rows=n_rows, g_rows=g_rows,
            )
        )
        brute = sum(
            1
            for j in range(bound)
            if bytes(corpus[j : j + 3]) == b"ACG"
        )
        assert got.tolist() == [brute], g_rows


def test_strided_shift_fold_equivalence():
    """stride > 1 (shift-folded kernel + strided conv) must produce
    bit-identical counts to stride = 1 — including at the window bound,
    on group-pad boundaries, and with mixed pattern lengths."""
    from apm.ops.corr_engine import (
        build_alphabet, build_kernel, pick_stride, scan_corr_conv,
    )
    import jax.numpy as jnp

    corpus = random_corpus(40000, seed=21)
    pats = [b"ACG", b"ACGTACGTAC", bytes(corpus[777:777 + 33])]
    plens = tuple(len(p) for p in pats)
    m_max = max(plens)
    wf, halo = 512, 128
    bound = len(corpus) - m_max + 1
    n_rows = -(-bound // wf)
    rows = np.zeros((n_rows, wf + halo), np.uint8)
    for r in range(n_rows):
        seg = corpus[r * wf : r * wf + wf + halo]
        rows[r, : len(seg)] = seg
    pat_raw = np.zeros((len(pats), m_max), np.uint8)
    for i, p in enumerate(pats):
        pat_raw[i, : len(p)] = np.frombuffer(p, np.uint8)
    alph = build_alphabet(pats)

    outs = {}
    from apm.ops.corr_engine import n_bitplanes

    for stride in (1, 4, pick_stride(len(pats))):
        kern, thr = build_kernel(pat_raw, plens, alph, stride=stride)
        assert kern.shape == (
            m_max + stride - 1,
            n_bitplanes(len(alph)),
            len(pats) * stride,
        )
        outs[stride] = np.asarray(
            scan_corr_conv(
                jnp.asarray(rows), jnp.asarray(kern), jnp.asarray(thr),
                jnp.asarray(alph),
                jnp.asarray(bound, jnp.int32), jnp.asarray(0, jnp.int32),
                wf=wf, m_max=m_max, n_rows=n_rows, g_rows=7,
                stride=stride,
            )
        )
    base = outs.pop(1)
    assert base.sum() > 0  # pattern 3 is planted: counts are non-trivial
    for stride, got in outs.items():
        assert got.tolist() == base.tolist(), stride


def test_strided_pieces_conv_equivalence():
    """Strided conv phase 1 must keep fcnt/rowmap identical to stride 1
    for non-NUL pieces (the padded overshoot may only add NUL-piece
    hits)."""
    from apm.ops.corr_engine import build_alphabet, build_piece_kernel, scan_pieces_conv
    import jax.numpy as jnp

    k = 1
    corpus = random_corpus(30000, seed=22)
    pats = [bytes(corpus[5000:5024]), bytes(corpus[17010:17040])]
    plens = tuple(len(p) for p in pats)
    m_max = max(plens)
    wf, halo = 512, 128
    bound = len(corpus) - m_max + 1
    n_rows = -(-bound // wf)
    rows = np.zeros((n_rows, wf + halo), np.uint8)
    for r in range(n_rows):
        seg = corpus[r * wf : r * wf + wf + halo]
        rows[r, : len(seg)] = seg
    pat_raw = np.zeros((len(pats), m_max), np.uint8)
    for i, p in enumerate(pats):
        pat_raw[i, : len(p)] = np.frombuffer(p, np.uint8)
    alph = build_alphabet(pats)

    outs = {}
    for stride in (1, 8):
        kern, thr, owner = build_piece_kernel(
            pat_raw, plens, k, alph, stride=stride
        )
        fcnt, rowmap = scan_pieces_conv(
            jnp.asarray(rows), jnp.asarray(kern), jnp.asarray(thr),
            jnp.asarray(owner), jnp.asarray(alph),
            jnp.asarray(bound, jnp.int32), jnp.asarray(0, jnp.int32),
            wf=wf, w_kern=kern.shape[0], n_rows=n_rows, g_rows=5,
            stride=stride,
        )
        outs[stride] = (np.asarray(fcnt), np.asarray(rowmap))
    f1, r1 = outs[1]
    f8, r8 = outs[8]
    assert f1.sum() > 0 and r1.any()
    assert f8.tolist() == f1.tolist()
    assert np.array_equal(r8, r1)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_piece_conv_rows_cover_matches(k):
    """Phase 1 soundness against the oracle: every staging row holding a
    window within distance k of a pattern is flagged by the piece
    correlation (the row map is a superset), so phase 2 can miss nothing."""
    from apm.ops.corr_engine import (
        _group_rows, build_alphabet, build_piece_kernel, scan_pieces_conv,
    )
    from apm.utils.oracle import banded_distances
    import jax.numpy as jnp

    corpus = random_corpus(24000, seed=30 + k, alphabet=b"ACGT")
    pats = [bytes(random_pattern(60, seed=31 + k)), bytes(random_pattern(55, seed=32 + k))]
    for i, p in enumerate(pats):
        plant(corpus, np.frombuffer(p, np.uint8), [700 + 9000 * i, 15000 + 77 * i],
              k=k, seed=33 + k + i)
    plens = tuple(len(p) for p in pats)
    m_max = max(plens)
    wf, halo = 512, 256
    bound = len(corpus) - m_max + 1
    n_rows = -(-bound // wf)
    rows = np.zeros((n_rows, wf + halo), np.uint8)
    for r in range(n_rows):
        seg = corpus[r * wf : r * wf + wf + halo]
        rows[r, : len(seg)] = seg
    raw = np.zeros((2, m_max), np.uint8)
    for i, p in enumerate(pats):
        raw[i, : len(p)] = np.frombuffer(p, np.uint8)
    alph = build_alphabet(pats)
    kern, thr, owner = build_piece_kernel(raw, plens, k, alph)
    fcnt, rowmap = scan_pieces_conv(
        jnp.asarray(rows), jnp.asarray(kern), jnp.asarray(thr),
        jnp.asarray(owner), jnp.asarray(alph),
        jnp.asarray(bound, jnp.int32), jnp.asarray(0, jnp.int32),
        wf=wf, w_kern=kern.shape[0], n_rows=n_rows,
        g_rows=_group_rows(wf + halo, len(alph), n_rows),
    )
    rowmap = np.asarray(rowmap)
    for i, p in enumerate(pats):
        hit = np.nonzero(banded_distances(corpus, p, k)[:bound] <= k)[0]
        assert len(hit) >= 2
        assert rowmap[np.unique(hit // wf), i].all(), (k, i)
        assert int(np.asarray(fcnt)[i]) > 0
