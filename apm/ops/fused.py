"""Filtration phase 1 + on-device candidate verification, and the
device-side position paths of :meth:`Scanner.find`.

One jitted device program per chunk runs the whole filtration pipeline:

* phase 1 (the piece correlation, ``apm.ops.corr_engine.scan_pieces_conv``)
  produces the per-staging-row candidate map *on device*;
* a device-side compaction (``nonzero`` + gathered ``take``) selects up to
  ``max_hot`` hot rows straight out of the device-resident staged corpus;
* the banded DP (``apm.ops.pallas_kernel``) verifies the gathered rows,
  masked to the true hot count.

The host receives only four tiny arrays per chunk — candidate totals,
verified totals, the hot-row count, and the (at most one) window-bound-
clipped hot row — so the common cases (zero candidates, sparse matches)
complete without a row-map fetch. Overflow (more than ``max_hot`` hot
rows) and high candidate density are detected from the hot-row count and
handled by the orchestrator (apm.models.pipeline) via device-side batches,
the host-staged path, or a banded-DP rescan.

The reference has no analog: its kernels always run the full DP per
window (``src/utils.c:76-99``).

The bucket sizes and caps below were set on a previous accelerator; none
is measured on the H100.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .pallas_kernel import DPStep, dp_count, dp_mask

# Row buckets are kept multiples of this (tidy shapes, no kernel need).
ROW_ALIGN = 8

# Hot-row compaction bucket floor: rows verified on device per chunk.
# 64 rows x (wf + halo) bytes is ~0.5-4 MB of gather output and ~0.2% of a
# 256 MB chunk's DP work.
MAX_HOT = 64

# Clipped-row slots: at most ONE row per chunk can straddle the window
# bound (rows tile the chunk disjointly; rows fully past the bound have
# every window masked and cannot be hot). 8 is pure safety margin.
MAX_CLIP = 8

# Hot-row bucket ceiling for pick_max_hot (rows). The gather output is
# max_hot * (wf + halo) bytes (~8.5 MB at 1024 x 8320) and the nonzero
# compaction is linear in R — both stay noise.
MAX_HOT_CAP = 1024


def pick_max_hot(n_rows: int, wf: int, plens, k: int) -> int:
    """Size the on-device hot-row bucket to the chunk.

    The fused program ALWAYS runs the banded verify over ``max_hot``
    gathered rows (masked to the true hot count), so the bucket is an
    always-on cost: budget it at ~1 op per scanned corpus byte — noise
    next to phase 1's ~100+ ops/byte — and grow it with the chunk. A
    256 MB chunk gets the full 1024 rows (one hot row per 256 KB of
    corpus before overflow), while wide pattern tables, whose per-row
    verify is expensive, stay at the floor.
    """
    ops_row = wf * sum(5 * (2 * k + 1) * m for m in plens if m > 0)
    budget_ops = n_rows * wf * 64  # ~64 verify ops per corpus window
    cap = min(n_rows // 20, budget_ops // max(ops_row, 1))
    cap = int(min(MAX_HOT_CAP, max(MAX_HOT, cap), max(n_rows, ROW_ALIGN)))
    return max(ROW_ALIGN, (cap // ROW_ALIGN) * ROW_ALIGN)


def _verify_phase2(
    corpus_rows, fcnt, rowmap, pat, bound, start, *, k, m_max, wf, plens,
    max_hot, dp,
):
    """Phase 2: gather hot rows from the device-resident staging, verify
    them with the banded DP, and pack the host-facing vector (see
    :func:`filter_verify_chunk_conv`).

    Verification runs over the *union* of hot rows with all ``plens``
    patterns: a row hot only for pattern A contributes zero to pattern B,
    because a B-match would imply a B-candidate (pigeonhole) and the row
    would be hot for B too."""
    r_rows = corpus_rows.shape[0]
    hot = jnp.sum(rowmap, axis=1) > 0  # (R,)
    row_start = (
        start.astype(jnp.int32)
        + jnp.arange(r_rows, dtype=jnp.int32) * wf
    )
    full = row_start + wf <= bound
    use = jnp.logical_and(hot, full)
    n_hot = jnp.sum(use.astype(jnp.int32))

    def _verify_with(bucket):
        # The banded verify sweeps all ``bucket`` staged rows regardless
        # of how many are real (static shapes; vbound only masks
        # counting) — so pick the bucket by the actual hot count under
        # lax.cond: zero-candidate chunks skip it entirely, lightly-hot
        # chunks (the planted-match steady state) pay a quarter bucket,
        # and only genuinely dense chunks sweep the full max_hot.
        def f():
            idx = jnp.nonzero(use, size=bucket, fill_value=r_rows)[0]
            stage = jnp.take(
                corpus_rows, idx, axis=0, mode="fill", fill_value=0
            )  # (bucket, wf + halo)
            vbound = jnp.minimum(n_hot, bucket) * wf
            return dp_count(
                stage, pat, vbound, jnp.int32(0),
                k=k, m_max=m_max, wf=wf, plens=plens, dp=dp,
            )
        return f

    zeros = lambda: jnp.zeros((pat.shape[0],), jnp.int32)
    small = max(ROW_ALIGN, (max_hot // 4 // ROW_ALIGN) * ROW_ALIGN)
    if small < max_hot:
        vcnt = jax.lax.cond(
            n_hot == 0,
            zeros,
            lambda: jax.lax.cond(
                n_hot <= small, _verify_with(small), _verify_with(max_hot)
            ),
        )
    else:
        vcnt = jax.lax.cond(n_hot > 0, _verify_with(max_hot), zeros)

    clip = jnp.logical_and(hot, jnp.logical_not(full))
    clip_idx = jnp.nonzero(clip, size=MAX_CLIP, fill_value=-1)[0]
    clip_starts = jnp.where(
        clip_idx >= 0, start + clip_idx.astype(jnp.int32) * wf, -1
    )
    packed = jnp.concatenate(
        [
            fcnt.astype(jnp.int32),
            vcnt.astype(jnp.int32),
            n_hot.reshape(1),
            clip_starts,
        ]
    )
    return packed, rowmap


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "m_max", "wf", "plens", "w_kern", "n_rows", "g_rows",
        "fp1_stride", "max_hot", "dp",
    ),
)
def filter_verify_chunk_conv(
    corpus_rows: jax.Array,  # (R, wf + halo) uint8 — staged corpus rows
    pkern: jax.Array,  # (w_kern, C, N) bf16 — one-hot piece kernel
    pthr: jax.Array,  # (N,) f32 — piece thresholds
    owner: jax.Array,  # (N, P) f32 — piece -> pattern one-hot
    alph: jax.Array,  # (C,) uint8 — pattern alphabet
    pat: jax.Array,  # (P, m_max + 2k) uint8 — k-padded pattern table
    bound: jax.Array,  # () int32 — global window bound (exclusive)
    start: jax.Array,  # () int32 — global window index of row 0
    *,
    k: int,
    m_max: int,
    wf: int,
    plens: tuple,
    w_kern: int,
    n_rows: int,
    g_rows: int,
    fp1_stride: int = 1,
    max_hot: int = MAX_HOT,
    dp: DPStep = DPStep(),
):
    """One-call phase 1 + phase 2 for one staged chunk (k >= 1).

    Phase 1 is pigeonhole piece matching as a correlation
    (``apm.ops.corr_engine.scan_pieces_conv``; row maps are a
    conservative superset — row-any candidacy); phase 2 verifies the hot
    rows exactly. Returns ``(packed, rowmap)``. ``packed`` is ONE int32
    vector, so the host pays one device-to-host fetch per chunk, layout
    ``[fcnt (P) | vcnt (P) | n_hot (1) | clip_starts (MAX_CLIP)]``:

    * ``fcnt`` — phase-1 candidate totals (0 iff no candidates);
    * ``vcnt`` — exact match counts over the first ``max_hot`` *full* hot
      rows (complete iff ``n_hot <= max_hot``);
    * ``n_hot`` — true number of full hot rows in this chunk;
    * ``clip_starts`` — global window starts of hot rows clipped by
      ``bound`` (-1 padding); verified host-side.

    ``rowmap`` (R, P) int32 is the phase-1 row map, left on device;
    fetched only for overflow recovery.
    """
    from .corr_engine import scan_pieces_conv

    assert k >= 1
    assert max_hot % ROW_ALIGN == 0 and max_hot > 0
    fcnt, rowmap = scan_pieces_conv(
        corpus_rows, pkern, pthr, owner, alph, bound, start,
        wf=wf, w_kern=w_kern, n_rows=n_rows, g_rows=g_rows,
        stride=fp1_stride,
    )
    return _verify_phase2(
        corpus_rows, fcnt, rowmap, pat, bound, start,
        k=k, m_max=m_max, wf=wf, plens=plens, max_hot=max_hot, dp=dp,
    )


# Overflow batch geometry for count_hot_batch: rows re-verified per
# dispatch, and the compaction ceiling (hot counts beyond OVERFLOW_CAP
# fall back to the orchestrator's host/rescan recovery; the density check
# usually routes such chunks to a full rescan first anyway).
OVERFLOW_BATCH = 512
OVERFLOW_CAP = 4096


@functools.partial(
    jax.jit,
    static_argnames=("k", "m_max", "wf", "plens", "n_batch", "cap", "dp"),
)
def count_hot_batch(
    corpus_rows: jax.Array,  # (R, wf + halo) uint8 — device-resident staging
    rowmap: jax.Array,  # (R, P) int32 — phase-1 row map (device-resident)
    pat: jax.Array,  # (P, m_max + 2k) uint8 — k-padded pattern table
    bound: jax.Array,  # () int32 — global window bound (exclusive)
    start: jax.Array,  # () int32 — global window index of row 0
    b: jax.Array,  # () int32 — overflow batch index (TRACED: one compile)
    *,
    k: int,
    m_max: int,
    wf: int,
    plens: tuple,
    n_batch: int = OVERFLOW_BATCH,
    cap: int = OVERFLOW_CAP,
    dp: DPStep = DPStep(),
):
    """Device-side overflow recovery: per-pattern counts over FULL hot
    rows ``[b*n_batch, (b+1)*n_batch)`` of one chunk (hot rows in row
    order, same ``hot & full`` criterion as
    :func:`filter_verify_chunk_conv`).

    When a chunk's hot count exceeds its fused ``max_hot`` bucket, the
    orchestrator re-verifies ALL its full hot rows by dispatching
    ``ceil(min(n_hot, cap)/n_batch)`` of these (batch index is a traced
    scalar — one compile serves any batch) and summing — the staging rows
    AND the row map stay device-resident. Rows past the true hot count
    gather zero-fill and are masked by the window bound.
    """
    assert n_batch % ROW_ALIGN == 0 and n_batch > 0
    assert cap % n_batch == 0
    r_rows = corpus_rows.shape[0]
    hot = jnp.sum(rowmap, axis=1) > 0  # (R,)
    row_start = (
        start.astype(jnp.int32)
        + jnp.arange(r_rows, dtype=jnp.int32) * wf
    )
    use = jnp.logical_and(hot, row_start + wf <= bound)
    n_hot = jnp.sum(use.astype(jnp.int32))
    idx_all = jnp.nonzero(use, size=cap, fill_value=r_rows)[0].astype(
        jnp.int32
    )
    idx = jax.lax.dynamic_slice(idx_all, (b * n_batch,), (n_batch,))
    stage = jnp.take(corpus_rows, idx, axis=0, mode="fill", fill_value=0)
    vbound = jnp.clip(n_hot - b * n_batch, 0, n_batch) * wf
    return dp_count(
        stage, pat, vbound, jnp.int32(0),
        k=k, m_max=m_max, wf=wf, plens=plens, dp=dp,
    )


# Hot rows verified per gather batch in Scanner.find's device position
# path. Larger than MAX_HOT (find is explicitly a position sweep, often
# dense) but bounded so the per-batch bit-packed verdict fetch stays small
# (n_batch * P * wf / 8 bytes — 512 KB/pattern at wf 8192).
FIND_BATCH = 512

# Per-ROW device position cap. Every verdict-mask row gets its first
# POS_CAP hit positions extracted on device (lax.top_k) so the host
# fetches a few KB of positions instead of multi-MB packed masks. A row
# holding more hits than the cap is incomplete; its batch falls back to
# the packed mask (computed under a lax.cond only in that case), so the
# contract stays exact for every density.
POS_CAP = 32


def _row_topk_positions(mask: jax.Array, p_real: int, wf: int, c: int):
    """Per-row ``top_k`` compaction of a ``(R, P, wf)`` verdict mask.

    Returns ``(pos, cnt)``: for each mask row, the first ``c`` hit
    positions as ascending flat indices into ``(p_real, wf)`` (-1
    padding), and the exact per-row hit count (a row with ``cnt > c`` is
    incomplete — the caller must fall back to the packed mask for its
    batch). Per pattern the decoded positions ascend within a row and
    across ascending rows — the segment-ascending contract of the mask
    path.
    """
    r = mask.shape[0]
    flat = (mask[:, :p_real, :wf] != 0).reshape(r, -1)
    L = flat.shape[1]
    cc = min(c, L)
    iota = jax.lax.broadcasted_iota(jnp.int32, (r, L), 1)
    keys = jnp.where(flat, L - iota, 0)  # descending keys = ascending iota
    v, _ = jax.lax.top_k(keys, cc)
    pos = jnp.where(v > 0, L - v, -1).astype(jnp.int32)
    if cc < c:
        pos = jnp.pad(pos, ((0, 0), (0, c - cc)), constant_values=-1)
    cnt = jnp.sum(flat.astype(jnp.int32), axis=1)
    return pos, cnt


def _bits_if(over: jax.Array, mask: jax.Array, p_real: int) -> jax.Array:
    """Bit-pack ``mask`` only when ``over`` is true at runtime (some row
    exceeded POS_CAP); zeros otherwise — the pack is a full pass over the
    mask, wasted whenever the compacted positions are complete."""
    r, _, wf = mask.shape
    return jax.lax.cond(
        over,
        lambda m: _pack_mask_bits(m, p_real),
        lambda m: jnp.zeros((r, p_real, wf // 32), jnp.uint32),
        mask,
    )


def _pack_mask_bits(mask: jax.Array, p_real: int) -> jax.Array:
    """Bit-pack a ``(R, P, wf) int8`` verdict mask to ``(R, p_real,
    wf // 32) uint32`` — window ``j'`` of row ``r`` is bit ``j' % 32``
    (little-endian) of word ``j' // 32``: 1 bit per window plus dropping
    the pattern-table padding rows shrinks the device-to-host fetch
    32x-plus."""
    r, _, wf = mask.shape
    bits = mask[:, :p_real, :].reshape(r, p_real, wf // 32, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(bits.astype(jnp.uint32) * weights, axis=-1, dtype=jnp.uint32)


def unpack_mask_bits(packed: "np.ndarray", pi: int, n_rows: int):
    """Host-side inverse of :func:`_pack_mask_bits` for one pattern:
    ``(n_rows, wf) uint8`` 0/1 verdicts."""
    import numpy as np

    sub = np.ascontiguousarray(packed[:n_rows, pi, :])
    return np.unpackbits(
        sub.view(np.uint8), bitorder="little"
    ).reshape(n_rows, sub.shape[1] * 32)


@functools.partial(
    jax.jit,
    static_argnames=("k", "m_max", "wf", "plens", "p_real", "dp", "pos_cap"),
)
def gather_mask_rows(
    corpus_rows: jax.Array,  # (R, wf + halo) uint8 — device-resident staging
    idx: jax.Array,  # (n_batch,) int32 — hot row indices (>= R = padding)
    pat: jax.Array,  # (P, m_max + 2k) uint8 — k-padded pattern table
    n_real: jax.Array,  # () int32 — true hot rows in this batch
    *,
    k: int,
    m_max: int,
    wf: int,
    plens: tuple,
    p_real: int,  # real pattern rows (table rows beyond are padding)
    dp: DPStep = DPStep(),
    pos_cap: int = POS_CAP,
):
    """Gather hot rows out of the device staging and return ``(posmeta,
    bits)``: the per-row device-compacted hit positions ``[cnt (n_batch)
    | pos (n_batch * pos_cap)]`` (see :func:`_row_topk_positions`) and
    the bit-packed per-window verdict mask ``(n_batch, p_real, wf//32)
    uint32`` — which is COMPUTED (and may be fetched) only when some
    row's ``cnt`` exceeds ``pos_cap``; zeros otherwise.

    The gather stays on device (the staging is already resident), the
    banded kernel re-runs only the gathered rows, and the caller maps
    mask coordinates back to global window starts via its own ``idx`` —
    this is :meth:`Scanner.find`'s overflow path, all positions resolved
    on the device instead of a host-side oracle re-scan.
    """
    stage = jnp.take(corpus_rows, idx, axis=0, mode="fill", fill_value=0)
    vbound = n_real.astype(jnp.int32) * wf
    mask = dp_mask(
        stage, pat, vbound, jnp.int32(0),
        k=k, m_max=m_max, wf=wf, plens=plens, dp=dp,
    )
    pos, cnt = _row_topk_positions(mask, p_real, wf, pos_cap)
    posmeta = jnp.concatenate([cnt, pos.reshape(-1)])
    return posmeta, _bits_if(jnp.any(cnt > pos_cap), mask, p_real)


def _positions_tail(
    corpus_rows, fcnt, rowmap, pat, bound, start, *, k, m_max, wf, plens,
    p_real, n_batch, dp, pos_cap,
):
    """Position-extraction tail: compact hot rows out of the
    device-resident staging, re-run the verdict-mask banded DP over them,
    and pack the host-facing ``(meta, pos, bits, rowmap)`` tuple. ``meta``
    layout: ``[fcnt (P) | n_hot (1) | idx (n_batch) | cnt (n_batch) |
    clip_starts (MAX_CLIP)]``; ``pos (n_batch, pos_cap)`` holds each
    row's device-compacted hit positions, and the bit-packed verdicts
    ``(n_batch, p_real, wf//32) uint32`` are computed only when some
    row's ``cnt`` exceeds ``pos_cap``."""
    r_rows = corpus_rows.shape[0]
    hot = jnp.sum(rowmap, axis=1) > 0  # (R,)
    row_start = (
        start.astype(jnp.int32)
        + jnp.arange(r_rows, dtype=jnp.int32) * wf
    )
    full = row_start + wf <= bound
    use = jnp.logical_and(hot, full)
    n_hot = jnp.sum(use.astype(jnp.int32))

    idx = jnp.nonzero(use, size=n_batch, fill_value=r_rows)[0].astype(
        jnp.int32
    )
    stage = jnp.take(corpus_rows, idx, axis=0, mode="fill", fill_value=0)
    vbound = jnp.minimum(n_hot, n_batch) * wf
    mask = dp_mask(
        stage, pat, vbound, jnp.int32(0),
        k=k, m_max=m_max, wf=wf, plens=plens, dp=dp,
    )

    clip = jnp.logical_and(hot, jnp.logical_not(full))
    clip_idx = jnp.nonzero(clip, size=MAX_CLIP, fill_value=-1)[0]
    clip_starts = jnp.where(
        clip_idx >= 0, start + clip_idx.astype(jnp.int32) * wf, -1
    )
    pos, cnt = _row_topk_positions(mask, p_real, wf, pos_cap)
    meta = jnp.concatenate(
        [fcnt.astype(jnp.int32), n_hot.reshape(1), idx, cnt, clip_starts]
    )
    bits = _bits_if(jnp.any(cnt > pos_cap), mask, p_real)
    return meta, pos, bits, rowmap


# Device-memory budget for the sweep's per-group mask transient: the group
# row count is derived from this budget at the actual (P, wf) — a fixed row
# count would overshoot on wide pattern tables.
SWEEP_MASK_BYTES = 64 << 20


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "m_max", "wf", "plens", "p_real", "n_batch", "dp", "pos_cap",
    ),
)
def sweep_positions_chunk(
    corpus_rows: jax.Array,  # (R, wf + halo) uint8 — staged corpus rows
    pat: jax.Array,  # (P, m_max + 2k) uint8 — k-padded pattern table
    bound: jax.Array,  # () int32 — global window bound (exclusive)
    start: jax.Array,  # () int32 — global window index of row 0
    *,
    k: int,
    m_max: int,
    wf: int,
    plens: tuple,  # static lengths; 0 = pattern not swept here
    p_real: int,
    n_batch: int = FIND_BATCH,
    dp: DPStep = DPStep(),
    pos_cap: int = POS_CAP,
):
    """One-call position extraction for one staged chunk (``Scanner.find``).

    The banded verdict-mask DP sweeps every staged row (``lax.map`` over
    row groups sized from :data:`SWEEP_MASK_BYTES` keeps the mask
    transient bounded), reducing each group's mask to per-row hit counts.
    That synthesized row map feeds the compaction / re-verification /
    position-compaction tail (:func:`_positions_tail`, the sparse
    regime's contract), PLUS — because every group's exact verdict mask
    already exists inside the sweep — a per-ROW device compaction ``gpos
    (R, pos_cap) int32`` of full-row hit positions, with the per-row
    full-hit counts ``gcnt (R)`` appended to ``meta``. In the dense
    regime (``n_hot > n_batch``) the host fetches ``gpos`` ONCE and
    decodes every position straight out of the sweep; only rows whose
    hits exceed ``pos_cap`` fall back to :func:`gather_mask_rows`.

    Returns ``(meta, pos, gpos, bits, rowmap)`` where ``meta`` is the
    tail layout with ``gcnt (R)`` appended:
    ``[fcnt (P) | n_hot | idx (n_batch) | cnt (n_batch) | clip_starts
    (MAX_CLIP) | gcnt (R)]``.
    """
    assert n_batch % ROW_ALIGN == 0 and n_batch > 0
    r_rows = corpus_rows.shape[0]
    p_pad = pat.shape[0]
    g_cap = max(1, SWEEP_MASK_BYTES // max(p_pad * wf * 4, 1))
    # Largest group <= g_cap that tiles the chunk exactly.
    g = next(d for d in range(min(g_cap, r_rows), 0, -1) if r_rows % d == 0)
    n_groups = r_rows // g

    def one_group(g0):
        stage = jax.lax.dynamic_slice_in_dim(corpus_rows, g0 * g, g, axis=0)
        mask = dp_mask(
            stage, pat,
            bound - start - g0 * (g * wf),  # group-local window bound
            jnp.int32(0),
            k=k, m_max=m_max, wf=wf, plens=plens, dp=dp,
        )
        rowcnt = jnp.sum(mask.astype(jnp.int32), axis=2)  # (g, P)
        # Per-row position compaction over FULL rows only (clipped rows
        # resolve host-side, same split as _positions_tail).
        ridx = g0 * g + jnp.arange(g, dtype=jnp.int32)
        full = (start + (ridx + 1) * wf) <= bound
        pos_g, cnt_g = _row_topk_positions(
            jnp.where(full[:, None, None], mask, 0), p_real, wf, pos_cap
        )
        return rowcnt, cnt_g, pos_g

    grp, gcnt, gpos = jax.lax.map(
        one_group, jnp.arange(n_groups, dtype=jnp.int32)
    )
    gcnt = gcnt.reshape(r_rows)
    gpos = gpos.reshape(r_rows, -1)
    rowmap = grp.reshape(r_rows, -1)
    fcnt = jnp.sum(rowmap, axis=0)
    meta, pos, bits, rowmap = _positions_tail(
        corpus_rows, fcnt, rowmap, pat, bound, start,
        k=k, m_max=m_max, wf=wf, plens=plens, p_real=p_real,
        n_batch=n_batch, dp=dp, pos_cap=pos_cap,
    )
    meta = jnp.concatenate([meta, gcnt.astype(jnp.int32)])
    return meta, pos, gpos, bits, rowmap


def unpack_chunk(packed, p: int):
    """Split a fetched ``packed`` vector back into its four parts."""
    import numpy as np

    packed = np.asarray(packed)
    return (
        packed[:p],
        packed[p : 2 * p],
        int(packed[2 * p]),
        packed[2 * p + 1 : 2 * p + 1 + MAX_CLIP],
    )
