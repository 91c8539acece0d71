"""Bit-parallel (Myers/Hyyro) banded-DP mode: conformance vs the classic
band and the NumPy oracle (interpret mode).

The two implementations must agree bit-for-bit on counts, masks, and batch
outputs for every k where the bit mode is representable (1 <= k <= 14);
``dp_impl="myers"`` forces it on, ``"band"`` forces it off, and the
Scanner-level tests exercise the full pipeline (filtration phase 2, find,
host tail) with the mode active. The kernel runs in the Pallas
interpreter.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from apm.models.scanner import Scanner
from apm.ops.common import fold_corpus, round_up
from apm.ops.pallas_kernel import (
    MYERS_KMIN_AUTO,
    DPStep,
    _myers_mode,
    dp_count,
    dp_mask,
    dp_scan,
)
from apm.utils.config import ApmConfig
from apm.utils.io import PatternSet
from apm.utils.oracle import as_u8, count_matches
from tests.conftest import random_dna

BAND = DPStep("pallas", interpret=True)


def _scanner_counts(corpus, patterns, k, dp_impl):
    cfg = ApmConfig(
        backend="pallas",
        interpret=True,
        strategy="single",
        block_windows=1024,
        dp_impl=dp_impl,
    )
    return Scanner(patterns, k, cfg).count(as_u8(corpus)).tolist()


def _kernel_args(corpus, patterns, k, wf=256):
    ps = PatternSet.from_patterns(patterns)
    pat, _ = ps.packed(k)
    buf = as_u8(corpus)
    m_max = ps.max_len
    halo = round_up(m_max + 2 * k, 128)
    bound = max(len(buf) - m_max + 1, 0)
    n_rows = max(1, -(-bound // wf))
    rows = fold_corpus(buf, 0, n_rows, wf, halo)
    alphabet = tuple(sorted({int(b) for p in ps.raw for b in p}))
    return (
        jnp.asarray(rows),
        jnp.asarray(pat),
        jnp.asarray(bound, jnp.int32),
        jnp.asarray(0, jnp.int32),
        dict(k=k, m_max=m_max, wf=wf, plens=tuple(int(x) for x in ps.lengths)),
        DPStep("pallas", interpret=True, alphabet=alphabet),
        bound,
        buf,
        ps,
    )


def _oracle_device_counts(buf, ps, k, bound):
    """Oracle counts over the kernel-owned (untruncated) windows only."""
    from apm.utils.oracle import banded_distances

    out = []
    for pb in ps.raw:
        d = banded_distances(buf, bytes(pb), k)
        out.append(int(np.sum(d[:bound] <= k)))
    return out


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 12, 14])
def test_kernel_myers_matches_band_and_oracle(k):
    rng = np.random.default_rng(100 + k)
    corpus = random_dna(6000, seed=k)
    pats = []
    for m in (max(k + 1, 8), 21, 34):
        pos = int(rng.integers(0, 5000))
        pb = bytearray(corpus[pos : pos + m].tobytes())
        for _ in range(k):  # mutate up to the threshold
            pb[int(rng.integers(0, m))] = ord("ACGT"[rng.integers(0, 4)])
        pats.append(bytes(pb))
    rows, pat, bound, start, kw, myers_dp, bnd, buf, ps = _kernel_args(
        corpus, pats, k
    )
    band = np.asarray(dp_count(rows, pat, bound, start, **kw, dp=BAND))
    myers = np.asarray(dp_count(rows, pat, bound, start, **kw, dp=myers_dp))
    ref = _oracle_device_counts(buf, ps, k, bnd)
    assert band.tolist() == ref
    assert myers.tolist() == ref


def test_kernel_myers_binary_alphabet():
    """Full byte range incl. NUL (collides with the pad byte) and 0xFF."""
    rng = np.random.default_rng(9)
    corpus = rng.choice(
        np.array([0, 1, 65, 255], np.uint8), size=4000
    ).astype(np.uint8)
    pats = [bytes(corpus[50:71]), bytes([0, 255, 0, 1, 65] * 3)]
    k = 4
    rows, pat, bound, start, kw, myers_dp, bnd, buf, ps = _kernel_args(
        corpus, pats, k
    )
    band = np.asarray(dp_count(rows, pat, bound, start, **kw, dp=BAND))
    myers = np.asarray(dp_count(rows, pat, bound, start, **kw, dp=myers_dp))
    assert band.tolist() == myers.tolist() == _oracle_device_counts(
        buf, ps, k, bnd
    )


def test_mask_kernel_myers_parity():
    corpus = random_dna(3000, seed=5)
    pats = [bytes(corpus[100:126]), bytes(corpus[700:715])]
    k = 6
    rows, pat, bound, start, kw, myers_dp, bnd, buf, ps = _kernel_args(
        corpus, pats, k
    )
    mb = np.asarray(dp_mask(rows, pat, bound, start, **kw, dp=BAND))
    mm = np.asarray(dp_mask(rows, pat, bound, start, **kw, dp=myers_dp))
    assert mb.sum() > 0
    np.testing.assert_array_equal(mb, mm)
    assert mb.sum(axis=(0, 2)).tolist() == _oracle_device_counts(
        buf, ps, k, bnd
    )


def test_batch_kernel_myers_parity():
    corpus = random_dna(2500, seed=6)
    pats = [bytes(corpus[10:30])]
    k = 5
    rows, pat, bound, start, kw, myers_dp, bnd, buf, ps = _kernel_args(
        corpus, pats, k
    )
    n_rows, wf = rows.shape[0], kw["wf"]
    # per-row table: odd rows carry a zero bound (every window masked)
    meta = jnp.asarray(
        [[int(bnd) if r % 2 == 0 else 0, r * wf] for r in range(n_rows)],
        jnp.int32,
    )
    cb = np.asarray(dp_scan(rows, pat, meta, **kw, dp=BAND))
    cm = np.asarray(dp_scan(rows, pat, meta, **kw, dp=myers_dp))
    np.testing.assert_array_equal(cb, cm)
    assert cb[1::2].sum() == 0 and cb[0::2].sum() > 0


def test_myers_mode_gating():
    a4 = (65, 67, 71, 84)
    assert not _myers_mode(0, a4, "auto", 4, 50)
    assert not _myers_mode(15, a4, "myers", 4, 50)  # band > 31 bits
    assert not _myers_mode(5, (), "myers", 4, 50)  # no alphabet
    assert not _myers_mode(5, a4, "myers", 4096, 50)  # PEQ table budget
    assert not _myers_mode(5, a4, "band", 4, 50)  # forced off
    assert not _myers_mode(5, tuple(range(9)), "myers", 4, 50)
    assert not _myers_mode(50, a4, "myers", 4, 50)  # k >= m_max
    assert _myers_mode(MYERS_KMIN_AUTO, a4, "auto", 4, 50)
    assert not _myers_mode(MYERS_KMIN_AUTO - 1, a4, "auto", 4, 50)
    assert _myers_mode(1, a4, "myers", 4, 50)  # forced on


@pytest.mark.parametrize("k", [3, 6, 9])
def test_scanner_end_to_end_myers(k):
    """Full Scanner pipeline (filtration phase 2 + DP fallback + host
    tail) with the bit-parallel band forced on: exact vs the oracle."""
    corpus = random_dna(20000, seed=40 + k)
    pats = [
        bytes(corpus[1000 : 1000 + max(k + 2, 12)]),  # short: DP path
        bytes(corpus[5000:5070]),  # long: filtration-eligible
    ]
    ref = count_matches(corpus, pats, k)
    got_m = _scanner_counts(corpus, pats, k, "myers")
    got_b = _scanner_counts(corpus, pats, k, "band")
    assert got_m == ref
    assert got_b == ref


def test_scanner_find_myers():
    corpus = random_dna(12000, seed=77)
    pats = [bytes(corpus[3000:3015])]
    k = 5
    cfg = ApmConfig(
        backend="pallas", interpret=True, strategy="single",
        block_windows=1024, dp_impl="myers",
    )
    sc = Scanner(pats, k, cfg)
    pos = sc.find(as_u8(corpus))
    from apm.utils.oracle import banded_distances

    d = banded_distances(as_u8(corpus), pats[0], k)
    expect = np.nonzero(d <= k)[0]
    np.testing.assert_array_equal(pos[0], expect)
