"""Banded Levenshtein DP over staged corpus rows.

This is the hot loop of every k >= 1 scan that filtration does not take,
of phase-2 verification, of :meth:`Scanner.find` and of
:meth:`Scanner.count_batch` — the re-design of the reference's two compute
kernels (the CPU single-column square DP, ``src/utils.c:76-99``, and the
CUDA grid-stride window kernel, ``src/patterns_over_ranks.cu:19-73``).

Two implementations share one contract, and :func:`resolve_dp_step` picks
between them in exactly one place:

* **a Pallas kernel lowered through Triton** (compiled on the GPU, or run
  by the Pallas interpreter under an explicit ``interpret=True``);
* **the plain XLA band** (:func:`apm.ops.xla_engine.band_rows_xla`, a ``fori_loop`` over DP
  steps on whole ``(P, rows, wf)`` arrays) — the CPU path and the
  reference the kernel is timed and checked against.

Layout. The corpus is staged host-side into overlapping rows: row ``r``
holds bytes ``[start_r, start_r + wf + halo)`` (zero-padded past EOF) and
owns the ``wf`` window starts ``start_r + [0, wf)``; a per-row meta table
``(bound_r, start_r)`` masks windows ``>= bound_r``. One table serves all
three callers: a single scan (``start_r = start + r * wf``, one bound),
``count_batch`` (each row carries its own corpus's bound) and the verdict
mask.

Kernel (one program per ``T``-window tile of one row; ``T`` a power of
two). Programs run in no fixed order, so nothing accumulates across the
grid: each program writes its own per-pattern partial count (or its
``T`` mask bytes) and XLA sums the partials. The DP state of one pattern
— the ``2k + 1`` band cells, or the Myers words — lives in registers for
all ``m`` steps; each step loads ``T`` text bytes at offset ``x - 1``
(consecutive steps hit L1) and the pattern bytes or PEQ words as scalars.
Patterns are a dynamic loop with dynamic lengths, so one compile serves
every pattern set of a given ``(k, m_max)`` and table height.

DP cells are unclamped int32 with an additive-safe INF for out-of-band
cells (values grow at most +1 per step); the first ``min(k, m_max)`` steps
are unrolled so the ``D[x][0] = x`` boundary column resolves at trace
time. EOF-truncated windows (``size = min(m, n - j) < m``,
``sequential.c:131``) are not handled here: the scanner owns windows
``j <= n - m_max`` on the device and counts the tail with the oracle.

Semantics: per-pattern count of window starts ``j < bound`` with banded
Levenshtein distance (band ``|d| <= k``) <= k, identical to
``sequential.c:104-144`` for untruncated windows.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .xla_engine import band_rows_xla

INF = 1 << 20  # additive-safe infinity for out-of-band cells

# --- bit-parallel (Myers/Hyyro) banded DP mode -----------------------------
# The classic band pays ~5 integer ops per diagonal per step (2k+1
# diagonals); the bit-parallel mode packs the whole band into one int32
# word per window and pays ~(2C + 15) ops per step (C = pattern-set
# alphabet size). k <= 14 keeps band width 2k+1 <= 29 bits clear of the
# int32 sign bit (the D0 carry chain may touch bit 2k+1).
# Auto crossover measured on an H100 (700 W; 256 MB, 2 DNA patterns of 32
# and 50 bytes): the band leads through k = 4 (7.4 vs 6.5 GB/s), Myers
# from k = 8 (6.6 vs 4.0); k = 5-7 were not measured.
MYERS_KMIN_AUTO = 5
MYERS_KMAX = 14
MYERS_CMAX = 8  # alphabet channels; PM costs 2 ops per channel per step
# PEQ table budget: the words are scalar loads served from L1, so the
# table of one call stays well inside one SM's 256 KB L1/shared array.
MYERS_PEQ_MAX_BYTES = 128 * 1024

# Windows per program (a power of two) and warps per program. Each
# thread holds T / (32 * num_warps) windows of band state in registers.
# Swept on an H100 (T 128-1024 x 1-8 warps, k = 2 band, k = 4 Myers,
# k = 8 band): 512 x 4 is within 4% of the best everywhere; wider tiles
# with fewer warps spill at k = 8.
TILE = 512
NUM_WARPS = 4

@dataclasses.dataclass(frozen=True)
class DPStep:
    """How the banded DP step runs — a static, hashable jit key.

    ``impl`` is ``"pallas"`` (the Triton kernel) or ``"xla"`` (the plain
    band); ``interpret`` runs the kernel in the Pallas interpreter;
    a non-empty ``alphabet`` selects the bit-parallel (Myers) band.
    """

    impl: str = "xla"
    interpret: bool = False
    alphabet: tuple = ()


def resolve_impl(backend: str, interpret: bool) -> str:
    """The ONE platform decision of the scan pipeline.

    The kernel runs compiled on ``"gpu"``, or in the Pallas interpreter
    when ``interpret=True`` is asked for explicitly; the plain XLA band
    runs on ``"cpu"`` (``backend="auto"``) or wherever ``backend="xla"``
    asks for it. Anything else raises — interpret mode is never chosen
    implicitly and there is no silent fallback.
    """
    if backend == "xla":
        return "xla"
    if interpret:
        return "pallas"
    platform = jax.devices()[0].platform
    if platform == "gpu":
        return "pallas"
    if platform == "cpu" and backend == "auto":
        return "xla"
    raise ValueError(
        f"the Pallas DP kernel needs a GPU (platform is {platform!r}); "
        "use backend='xla', or interpret=True to run the kernel in the "
        "Pallas interpreter"
    )


def _myers_mode(
    k: int, alphabet: tuple, dp_impl: str, p: int, m_max: int
) -> bool:
    """Run the bit-parallel band instead of the classic diagonal band?
    ``dp_impl``: "auto" (measured crossover), "band" (never), "myers"
    (whenever representable)."""
    if dp_impl == "band" or not alphabet:
        return False
    if not (1 <= k <= MYERS_KMAX) or len(alphabet) > MYERS_CMAX:
        return False
    if k >= m_max:  # the static phase reads PEQ row k
        return False
    if p * m_max * len(alphabet) * 4 > MYERS_PEQ_MAX_BYTES:
        return False
    return True if dp_impl == "myers" else k >= MYERS_KMIN_AUTO


def resolve_dp_step(
    *, k: int, m_max: int, n_pat: int, alphabet: tuple, dp_impl: str,
    backend: str, interpret: bool,
) -> DPStep:
    """Build the static DP descriptor for one scanner.

    The alphabet is kept only when the Myers mode is on, so pattern sets
    with equal lengths but different bytes share one compile of the
    classic band. The plain XLA band has no Myers mode.
    """
    impl = resolve_impl(backend, interpret)
    if impl == "xla":
        return DPStep("xla")
    myers = _myers_mode(k, tuple(alphabet), dp_impl, n_pat, m_max)
    return DPStep("pallas", bool(interpret), tuple(alphabet) if myers else ())


def _build_peq(pat: jax.Array, k: int, m_max: int, alphabet: tuple):
    """Match-bit table for the bit-parallel band: ``peq[pi*m_max + X, c]``
    bit ``b`` set iff ``pat[pi, X + b] == alphabet[c]`` (``pat`` is the
    k-padded table, so X indexes DP steps: the moving band at step x reads
    row ``x - 1``; the static boundary phase reads row ``k``).
    ``(P * m_max, C)`` int32."""
    B = 2 * k + 1
    p = pat.shape[0]
    p32 = pat.astype(jnp.int32)  # (P, m_max + 2k)
    wins = jnp.stack([p32[:, X : X + B] for X in range(m_max)], axis=1)
    alph = jnp.asarray(alphabet, jnp.int32)
    eq = wins[..., None] == alph  # (P, m_max, B, C)
    bits = eq.astype(jnp.int32) << jnp.arange(B, dtype=jnp.int32).reshape(
        1, 1, B, 1
    )
    return jnp.sum(bits, axis=2).reshape(p * m_max, len(alphabet))


def _band_res(ptab_ref, i, m, text, *, k, m_max, T):
    """Classic diagonal band for pattern slot ``i`` of length ``m``:
    returns ``D[m][m]`` per window (``band[k + d] = D[x][x + d]``)."""
    xs = min(k, m_max)

    def step(x, band, static):
        tx = text(x)
        new, prev = [], None
        for di in range(2 * k + 1):
            d = di - k
            if static and x + d == 0:
                val = jnp.full((T,), x, jnp.int32)  # boundary D[x][0] = x
            elif static and x + d < 0:
                val = jnp.full((T,), INF, jnp.int32)
            else:
                pc = ptab_ref[i, x - 1 + d + k]
                val = band[di] + (tx != pc).astype(jnp.int32)  # substitution
                if d < k:
                    val = jnp.minimum(val, band[di + 1] + 1)  # deletion
                if prev is not None:
                    val = jnp.minimum(val, prev + 1)  # insertion
            new.append(val)
            prev = val
        return new

    # Row x = 0: D[0][y] = y for y in [0, k], INF below the diagonal.
    band = [
        jnp.full((T,), d if d >= 0 else INF, jnp.int32)
        for d in range(-k, k + 1)
    ]
    res = jnp.full((T,), INF, jnp.int32)
    for x in range(1, xs + 1):  # boundary steps, unrolled
        band = step(x, band, True)
        res = jnp.where(m == x, band[k], res)
    band = jax.lax.fori_loop(
        xs + 1, m + 1, lambda x, b: tuple(step(x, list(b), False)),
        tuple(band),
    )
    return jnp.where(m > xs, band[k], res)


def _myers_res(peq_ref, i, m, text, *, k, m_max, T, alphabet):
    """Bit-parallel band for pattern slot ``i`` of length ``m``.

    Per window the band's 2k+1 cells live as vertical delta bit vectors
    ``VP``/``VN`` (bit b = R[b] - R[b-1] in band coordinates) plus the
    main-diagonal value ``cc``; each step is Hyyro's block update instead
    of 2k+1 per-diagonal min-chains. Three phases:

    1. *static* (x = 1..k): the band covers pattern rows 1..2k+1 with the
       exact ``D[0][x] = x`` boundary encoded by a constant horizontal
       carry-in of +1; the initial column D[y][0] = y is all-ones VP;
    2. *conversion* at x = k: one shift re-indexes the static band onto
       the moving (diagonal) band;
    3. *moving* (x = k+1..m): the band shifts down one row per step
       (``VP >> 1``) with a fake top delta of +1; out-of-band cells act
       as ``>= k+1`` surrogates, which preserves the ``<= k`` verdict
       exactly (computed == true whenever true <= k).

    ``cc`` advances by ``1 - bit_center(D0)`` with ``D0 = Xh | VN``.
    """
    B = 2 * k + 1
    maskB = (1 << B) - 1
    topbit = 1 << (B - 1)

    def pm(tx, row):
        # PM = OR_c (text == alphabet[c]) ? PEQ[i, row, c] : 0
        acc = None
        for ci, a in enumerate(alphabet):
            term = jnp.where(tx == a, peq_ref[i * m_max + row, ci], 0)
            acc = term if acc is None else acc | term
        return acc

    def bit_step(st, Eq, cbit):
        VP, VN, cc = st
        Xv = Eq | VN
        Xh = (((Eq & VP) + VP) ^ VP) | Eq
        Ph = VN | (~(Xh | VP) & maskB)
        Mh = VP & Xh
        Ph = ((Ph << 1) & maskB) | 1  # horizontal carry-in = +1
        Mh = (Mh << 1) & maskB
        nVP = Mh | (~(Xv | Ph) & maskB)
        nVN = Ph & Xv
        cc = cc + (1 - (((Xh | VN) >> cbit) & 1))
        return nVP, nVN, cc

    full = lambda v: jnp.full((T,), v, jnp.int32)
    st = (full(maskB), full(0), full(0))
    res = full(INF)
    for x in range(1, k + 1):  # static band; center row x <-> bit x-1
        st = bit_step(st, pm(text(x), k), x - 1)
        res = jnp.where(m == x, st[2], res)
    VP, VN, cc = st
    st = (((VP << 1) | 1) & maskB, (VN << 1) & maskB, cc)

    def body(x, st):
        VP, VN, cc = st
        shifted = ((VP >> 1) | topbit, VN >> 1, cc)
        return bit_step(shifted, pm(text(x), x - 1), k)

    st = jax.lax.fori_loop(k + 1, m + 1, body, st)
    return jnp.where(m > k, st[2], res)


def _dp_kernel(
    meta_ref,  # (R, 2) int32 — per-row [window bound, window start]
    ptab_ref,  # band: (n_act, m_max + 2k) int32 chars; Myers: PEQ words
    plen_ref,  # (n_act,) int32 — pattern lengths
    rows_ref,  # (R, wf + halo) uint8 — staged corpus rows
    out_ref,  # counts: (R * n_tiles, n_act) int32; mask: (R, n_act, wf) int8
    *,
    k: int,
    m_max: int,
    T: int,
    n_tiles: int,
    n_act: int,
    alphabet: tuple,
    mask: bool,
):
    prog = pl.program_id(0)
    r = prog // n_tiles
    off = (prog % n_tiles) * T
    bound = meta_ref[r, 0]
    start = meta_ref[r, 1]
    lane = jax.lax.broadcasted_iota(jnp.int32, (T,), 0)
    valid = start + off + lane < bound

    def text(x):  # the T text bytes that DP step x compares
        return rows_ref[r, pl.ds(off + x - 1, T)].astype(jnp.int32)

    def one_pattern(i, carry):
        m = plen_ref[i]
        if alphabet:
            res = _myers_res(
                ptab_ref, i, m, text, k=k, m_max=m_max, T=T,
                alphabet=alphabet,
            )
        else:
            res = _band_res(ptab_ref, i, m, text, k=k, m_max=m_max, T=T)
        hits = jnp.logical_and(res <= k, valid)
        if mask:
            out_ref[r, i, pl.ds(off, T)] = hits.astype(jnp.int8)
        else:
            out_ref[prog, i] = jnp.sum(hits.astype(jnp.int32))
        return carry

    jax.lax.fori_loop(0, n_act, one_pattern, 0)


def pick_tile(wf: int) -> int:
    """Largest power of two <= TILE that divides ``wf``."""
    t = TILE
    while t > 1 and wf % t:
        t //= 2
    return t


def _dp_pallas(rows, pat, plen, meta, *, k, m_max, wf, dp, mask, tile):
    """The kernel over the ``n_act`` patterns of ``pat``: per-program
    partial counts ``(R, n_tiles, n_act)`` or the mask ``(R, n_act, wf)``."""
    r_rows = rows.shape[0]
    n_act = pat.shape[0]
    T = tile or pick_tile(wf)
    assert wf % T == 0, (wf, T)
    n_tiles = wf // T
    if dp.alphabet:
        ptab = _build_peq(pat, k, m_max, dp.alphabet)
    else:
        ptab = pat.astype(jnp.int32)
    if mask:
        out_shape = jax.ShapeDtypeStruct((r_rows, n_act, wf), jnp.int8)
    else:
        out_shape = jax.ShapeDtypeStruct((r_rows * n_tiles, n_act), jnp.int32)
    out = pl.pallas_call(
        functools.partial(
            _dp_kernel, k=k, m_max=m_max, T=T, n_tiles=n_tiles, n_act=n_act,
            alphabet=dp.alphabet, mask=mask,
        ),
        grid=(r_rows * n_tiles,),
        out_shape=out_shape,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=dp.interpret,
        name="apm_banded_dp_mask" if mask else "apm_banded_dp",
    )(meta, ptab, plen, rows)
    return out if mask else out.reshape(r_rows, n_tiles, n_act)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "m_max", "wf", "plens", "dp", "mask", "tile",
    ),
)
def dp_scan(
    rows: jax.Array,  # (R, wf + halo) uint8 — staged corpus rows
    pat: jax.Array,  # (P, m_max + 2k) uint8 — k-padded pattern table
    meta: jax.Array,  # (R, 2) int32 — per-row [window bound, window start]
    *,
    k: int,
    m_max: int,
    wf: int,
    plens: tuple,  # static per-pattern lengths (0 = not scanned here)
    dp: DPStep,
    mask: bool = False,
    tile: int = 0,  # kernel tile override (0 = pick_tile)
):
    """Per-row per-pattern match counts ``(R, P)`` int32, or with
    ``mask=True`` the verdict mask ``(R, P, wf)`` int8 (``mask[r, p, j]``
    = 1 iff window ``start_r + j`` matches pattern ``p`` and is below
    ``bound_r``). Patterns with ``plens[p] == 0`` give zeros."""
    r_rows, wpf = rows.shape
    p = pat.shape[0]
    assert len(plens) == p, (len(plens), p)
    assert wpf >= wf + m_max - 1, (wpf, wf, m_max)
    assert meta.shape == (r_rows, 2), (meta.shape, r_rows)
    meta = meta.astype(jnp.int32)
    act = [i for i, m in enumerate(plens) if m > 0]
    if not act:
        shape = (r_rows, p, wf) if mask else (r_rows, p)
        return jnp.zeros(shape, jnp.int8 if mask else jnp.int32)
    idx = jnp.asarray(act, jnp.int32)
    sub = pat[idx]
    plen = jnp.asarray([plens[i] for i in act], jnp.int32)
    if dp.impl == "pallas":
        out = _dp_pallas(
            rows, sub, plen, meta, k=k, m_max=m_max, wf=wf, dp=dp,
            mask=mask, tile=tile,
        )
        got = out if mask else jnp.sum(out, axis=1)  # (R, n_act[, wf])
    elif dp.impl == "xla":
        hits = band_rows_xla(rows, sub, plen, meta, k=k, m_max=m_max, wf=wf)
        got = (
            hits.astype(jnp.int8)
            if mask
            else jnp.sum(hits, axis=2, dtype=jnp.int32)
        )
    else:
        raise ValueError(f"unknown DP implementation {dp.impl!r}")
    if len(act) == p:
        return got
    shape = (r_rows, p, wf) if mask else (r_rows, p)
    return jnp.zeros(shape, got.dtype).at[:, idx].set(got)


def row_meta(n_rows: int, wf: int, bound, start) -> jax.Array:
    """Per-row ``[bound, start + r * wf]`` table of one contiguous scan."""
    starts = jnp.asarray(start, jnp.int32) + wf * jnp.arange(
        n_rows, dtype=jnp.int32
    )
    bounds = jnp.broadcast_to(jnp.asarray(bound, jnp.int32), (n_rows,))
    return jnp.stack([bounds, starts], axis=1)


def dp_count(rows, pat, bound, start, *, k, m_max, wf, plens, dp):
    """Per-pattern counts ``(P,)`` of the windows ``[start, bound)`` of one
    contiguous staged scan (row ``r`` starts at window ``start + r*wf``)."""
    meta = row_meta(rows.shape[0], wf, bound, start)
    per_row = dp_scan(
        rows, pat, meta, k=k, m_max=m_max, wf=wf, plens=plens, dp=dp
    )
    return jnp.sum(per_row, axis=0, dtype=jnp.int32)


def dp_mask(rows, pat, bound, start, *, k, m_max, wf, plens, dp):
    """Verdict mask ``(R, P, wf)`` int8 of one contiguous staged scan."""
    meta = row_meta(rows.shape[0], wf, bound, start)
    return dp_scan(
        rows, pat, meta, k=k, m_max=m_max, wf=wf, plens=plens, dp=dp,
        mask=True,
    )
