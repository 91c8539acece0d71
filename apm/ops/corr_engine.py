"""Exact-match (k = 0) scanning as a ±1 bit-plane correlation.

At k = 0 approximate matching degenerates to exact matching, and exact
matching is a *correlation*: window ``j`` matches pattern ``p`` iff

    sum_i [text[j + i] == p[i]]  ==  m_p .

Encode symbols over channels so per-position equality becomes an inner
product, and the whole scan is ONE convolution —
``(R, L, C) * (m_max, C, P) -> (R, W, P)`` — which XLA hands to its
convolution libraries (cuDNN / cuBLAS on the GPU) instead of the
compare-and-min chains of the banded DP. The banded DP
(``apm.ops.pallas_kernel``) stays the engine for k >= 1, where the DP
recurrence has no such bilinear form.

**±1 bit-planes, not one-hot (round 5).** Because the k = 0 test is
all-or-nothing, the channel axis does not need to *count* per-position
equality — it only needs an equality *certificate* at the threshold.
Encode each text byte's alphabet code (its index in the sorted pattern
alphabet) as ``B = max(1, ceil(log2 C))`` channels of ±1 (bit b set →
+1, clear → -1; bytes outside the alphabet → all-zero), and give the
kernel the pattern bytes' ±1 code bits. Each in-pattern tap then
contributes exactly B when every code bit matches and <= B - 2
otherwise, so

    corr[j, p] == B * m_p   ⟺   window j matches pattern p exactly

(the maximum is attainable only by all-match, and any mismatched symbol
loses >= 2 from at least one plane). DNA's 4-5 channel one-hot becomes
2-3 bit-planes: 2-2.5x fewer multiply-adds in the contraction and
2-2.5x fewer encoded elements. One-hot still generalizes to counting *partial* matches; nothing in this engine
needs that — phase 1 pieces (below) are exact-threshold too.

Two tricks make one conv serve an arbitrary pattern set:

* **Per-pattern thresholds, not padding channels.** Kernel positions past
  a pattern's real length stay all-zero and the match test is
  ``corr >= B * m_p`` per pattern (``corr`` cannot exceed ``B * m_p``):
  no wildcard channel, no concat in the hot path. (Text bytes outside the alphabet
  encode to the zero vector and can never complete a match — correct,
  since every pattern byte is in the alphabet by construction.)
* **Alphabet-code channels, not byte channels.** Codes index the distinct
  bytes of the pattern set (4-5 for DNA), not all 256 byte values, so
  the contraction stays dense and the plane count minimal.

Window-ownership masking is a per-ROW limit (one clipped subtract per
row, ``col < limit[r]``) rather than a per-window global-index compare.

Exactness: inputs are 0/±1 in bf16, accumulation is f32
(``preferred_element_type``), partial sums are integers with
``|corr| <= B * m_max`` — every value is exactly representable for
``B * m_max < 2**24``, so the ``corr >= B * m_p`` test is bit-exact.
The operands MUST be bf16: f32 operands may run as TF32 on the GPU's
tensor cores, which keeps 10 mantissa bits and would round the sums, so
every conv asserts its operand dtypes (:func:`_conv`). The engine is
conformance-tested against the oracle like every other engine
(tests/test_corr.py).

Eligibility (:func:`corr_eligible`): k = 0, alphabet <= ``ALPHABET_MAX``
(beyond that the contraction dilutes — each extra channel is pure FLOP
overhead), ``m_max <= M_MAX_CORR`` (conv kernel width; long patterns are
better served by the pigeonhole filter's piece scan). Ineligible scans
fall back to the round-1 engines unchanged.

The reference has no analog of either formulation: its CPU and CUDA
kernels run the full O(m^2) DP per window (``src/utils.c:76-99``,
``src/cuda_utils.cu``) even at k = 0.

Memory: the bit-plane text tile is ``(rows, L, B)`` bf16 — ~4-6x the
staged bytes for DNA (the one-hot tile was ~10-12x) — so the scan maps
over static row *groups* sized ~``GROUP_BYTES`` of encoded text, keeping
the working set in the tens of MB.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Channels beyond this dilute the contraction (every extra channel
# multiplies conv FLOPs); binary-ish pattern sets fall back to the
# pigeonhole/banded engines.
ALPHABET_MAX = 16

# Conv kernel width cap. Longer patterns are dominated by the pigeonhole
# filter anyway (a selective piece scan reads each text byte once; the
# conv reads each m_max times).
M_MAX_CORR = 512

# "auto" crossover: corr takes a k = 0 scan when the distinct pattern bytes
# total >= AUTO_MIN_WORK or the longest pattern >= AUTO_MIN_MMAX (the
# banded DP's work grows with pattern bytes, the conv's stays flat);
# engine="corr" bypasses both. Set from a previous accelerator's
# measurements; not measured on the H100.
AUTO_MIN_WORK = 256
AUTO_MIN_MMAX = 48

# Target bytes of encoded text materialized per mapped row group (not
# measured on the H100).
GROUP_BYTES = 64 << 20


def build_alphabet(raw_patterns) -> np.ndarray:
    """Sorted distinct bytes across the pattern set, as (C,) uint8."""
    if not raw_patterns:
        return np.zeros((0,), dtype=np.uint8)
    cat = np.concatenate(
        [np.frombuffer(bytes(p), dtype=np.uint8) for p in raw_patterns]
    )
    return np.unique(cat)


def n_bitplanes(alphabet_size: int) -> int:
    """±1 channel count for a C-symbol alphabet: ``max(1, ceil(log2 C))``.

    2 for DNA (C = 4), 3 for DNA+N (C = 5), 1 for binary pattern sets,
    4 at the ``ALPHABET_MAX = 16`` eligibility edge.
    """
    return max(1, (max(alphabet_size, 1) - 1).bit_length())


def _encode_planes(rg: jax.Array, alph: jax.Array, cbits: int) -> jax.Array:
    """±1 bit-plane text encode: ``(g, L) uint8 -> (g, L, cbits) bf16``.

    Plane b of a byte in the alphabet is ``+1`` if bit b of its alphabet
    code (index in the sorted ``alph``) is set, else ``-1``; bytes
    outside the alphabet encode to the zero vector on every plane (a
    zero tap term can never help a window reach the ``B * m_p``
    threshold, so out-of-alphabet text is excluded exactly as one-hot's
    zero row excluded it). Cost per byte: 2C compares + B selects — vs
    one-hot's C compare/selects producing C (not B) output elements."""
    eq = rg[:, :, None] == alph[None, None, :]  # (g, L, C)
    valid = jnp.any(eq, axis=-1)  # (g, L)
    code = jnp.sum(
        (rg[:, :, None] > alph[None, None, :]).astype(jnp.int32),
        axis=-1,
    )  # (g, L): rank of the byte among alphabet bytes == its code
    bits = (
        code[:, :, None] >> jnp.arange(cbits, dtype=jnp.int32)[None, None, :]
    ) & 1  # (g, L, cbits)
    pm = (2 * bits - 1).astype(jnp.bfloat16)
    return jnp.where(valid[:, :, None], pm, jnp.bfloat16(0.0))


def _conv(t: jax.Array, kern: jax.Array, stride: int) -> jax.Array:
    """The one correlation of this module: ``(g, L, B) * (w, B, N)`` with
    bf16 ±1 operands and f32 accumulation — exact for integer sums below
    2^24 (see the module docstring; f32 operands could run as TF32)."""
    assert t.dtype == jnp.bfloat16 and kern.dtype == jnp.bfloat16, (
        t.dtype, kern.dtype,
    )
    return jax.lax.conv_general_dilated(
        t,
        kern,
        window_strides=(stride,),
        padding="VALID",
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.float32,
    )


def corr_eligible(
    plens, alphabet_size: int, m_max: int, k: int, auto: bool = False
) -> bool:
    """Gate for the correlation engine (see module docstring).

    With ``auto=True`` the measured crossover applies on top of the hard
    requirements: corr takes the scan only when the pattern set is heavy
    (``sum >= AUTO_MIN_WORK``) or long (``m_max >= AUTO_MIN_MMAX``) —
    the regimes where the conv measured ahead of the banded kernel.
    """
    ok = (
        k == 0
        and 0 < alphabet_size <= ALPHABET_MAX
        and 0 < m_max <= M_MAX_CORR
        and any(m > 0 for m in plens)
    )
    if not ok or not auto:
        return ok
    return sum(plens) >= AUTO_MIN_WORK or m_max >= AUTO_MIN_MMAX


def pick_stride(n0: int) -> int:
    """Shift-fold stride ``S`` for a conv with ``n0`` base output channels.

    A stride-1 correlation with few patterns (or pieces) has a narrow
    output-channel axis, which leaves the contraction's output tile mostly
    empty. Folding ``S`` *shifted* copies of every pattern into the channel
    axis and striding the conv by ``S`` computes the identical per-window
    scores with ``N = n0*S`` channels — ~``S``x the column utilization for
    only ``(m + S - 1)/m``x the FLOPs. Past ~24 base channels the fold
    stops paying, so n0 > 24 keeps stride 1. The thresholds were set on a
    previous accelerator; not measured on the H100.

    Strides are powers of two capped at 32 and at N <= 128; every block
    width is a multiple of 128 windows, so divisibility is guaranteed.
    """
    if n0 > 24:
        return 1
    s = 1
    while s < 32 and n0 * s * 2 <= 128:
        s *= 2
    return s


def _fold_shifts(kern: np.ndarray, thr: np.ndarray, stride: int):
    """Fold ``stride`` shifted copies of a base conv kernel into the
    channel axis: channel ``s*n0 + c`` scores base channel ``c`` at window
    offset ``s`` within a stride block (so a strided conv's output block
    ``jb`` reshapes to windows ``jb*stride + s``)."""
    if stride == 1:
        return kern, thr
    wk, C, n0 = kern.shape
    ks = np.zeros((wk + stride - 1, C, n0 * stride), dtype=kern.dtype)
    for s in range(stride):
        ks[s : s + wk, :, s * n0 : (s + 1) * n0] = kern
    return ks, np.tile(thr, stride)


def build_kernel(
    pat_raw: np.ndarray, plens, alphabet: np.ndarray, stride: int = 1
):
    """±1 bit-plane conv kernel ``(m_max + stride - 1, B, P*stride)``
    bf16 + ``(P*stride,)`` f32 thresholds (``B = n_bitplanes(C)``).

    ``pat_raw`` is the (P, m_max) zero-padded raw pattern table. Position
    ``i`` of pattern ``p`` carries the ±1 code bits of its byte for
    ``i < m_p``; positions past the pattern (and whole pattern-axis
    padding rows, ``m_p = 0``) stay all-zero. The returned threshold for
    pattern ``p`` is ``B * m_p`` — ``corr >= B * m_p`` iff every real
    position matched on every plane (see the module docstring's
    certificate argument) — and an unreachable sentinel for padding rows
    so they never count (the same "no work for padding rows" contract as
    the Pallas kernels). ``stride`` shift-folds the kernel for the
    strided conv (see :func:`pick_stride`); pass the same value to
    :func:`scan_corr_conv`.
    """
    P, m_max = pat_raw.shape
    B = n_bitplanes(len(alphabet))
    kern = np.zeros((m_max, B, P), dtype=np.float32)
    thr = np.zeros((P,), dtype=np.float32)
    for pi in range(P):
        m = plens[pi]
        thr[pi] = B * m if m > 0 else np.float32(2**30)
        for i in range(min(m, m_max)):
            ci = int(np.searchsorted(alphabet, pat_raw[pi, i]))
            for b in range(B):
                kern[i, b, pi] = 1.0 if (ci >> b) & 1 else -1.0
    kern, thr = _fold_shifts(kern, thr, stride)
    return kern.astype(jnp.bfloat16), thr


def _group_rows(L: int, C: int, n_rows: int) -> int:
    """Rows per mapped group: ~GROUP_BYTES of encoded text, >= 8,
    <= n_rows. ``C`` is the ALPHABET size (what every caller has on
    hand); the encoded tile is ``n_bitplanes(C)`` bf16 planes wide."""
    per_row = L * n_bitplanes(C) * 2
    g = max(8, GROUP_BYTES // max(per_row, 1))
    return int(min(g, n_rows))


@functools.partial(
    jax.jit,
    static_argnames=("wf", "m_max", "n_rows", "g_rows", "stride", "p_out"),
)
def scan_corr_conv(
    rows: jax.Array,  # (R, wf + halo) uint8 — folded staged corpus rows
    kern: jax.Array,  # (m_max + S - 1, B, P*S) bf16 — shift-folded kernel
    thr: jax.Array,  # (P*S,) f32 — per-channel match thresholds (= m_p)
    alph: jax.Array,  # (C,) uint8 — pattern alphabet
    bound: jax.Array,  # () int32 — global window bound (exclusive)
    start: jax.Array,  # () int32 — global window index of row 0
    *,
    wf: int,
    m_max: int,
    n_rows: int,  # rows that carry real windows (R may be group-padded)
    g_rows: int,  # rows per mapped group (static)
    stride: int = 1,  # shift-fold stride S (see pick_stride)
    p_out: int = 0,  # zero-pad the count vector to this length (pattern
    # tables are padded to a multiple of 8 but the conv kernel carries
    # REAL patterns only — all-zero padding columns would still cost MACs)
):
    """(max(P, p_out),) int32 exact-match counts for this chunk's
    device-owned windows.

    Same ownership contract as the Pallas kernels: row ``r`` owns global
    windows ``[start + r*wf, start + (r+1)*wf)`` intersected with
    ``[0, bound)``; rows past ``n_rows`` (group padding) own nothing.
    (The explicit ``n_rows`` mask matters even though padded rows are
    zero-filled: a binary pattern may legitimately contain NUL bytes and
    would otherwise match the padding.)

    With ``stride = S > 1`` the conv strides by S and the kernel carries S
    shifted copies of every pattern (:func:`build_kernel` with the same
    ``stride``): output block ``jb``'s channel ``s*P + p`` is window
    ``jb*S + s`` of pattern ``p`` — identical scores at ~S x the output
    column utilization. Reads reach ``wf + m_max - 2`` regardless of S,
    so any ``halo >= m_max - 1`` staging row suffices.
    """
    R, L = rows.shape
    S = stride
    assert wf % S == 0, (wf, S)
    G = -(-R // g_rows)
    pad = G * g_rows - R
    if pad:
        rows = jnp.pad(rows, ((0, pad), (0, 0)))
    grouped = rows.reshape(G, g_rows, L)

    col = jnp.arange(wf, dtype=jnp.int32)[None, :]
    row_in_g = jnp.arange(g_rows, dtype=jnp.int32)[:, None]

    def one_group(args):
        rg, g = args  # (g_rows, L) uint8, () int32
        t = _encode_planes(rg, alph, kern.shape[1])
        corr = _conv(t, kern, S)  # (g_rows, (L - wk)//S + 1, P*S)
        match = corr[:, : wf // S, :] >= thr[None, None, :]
        if S > 1:  # block jb, channel s*P+p  ->  window jb*S + s
            match = match.reshape(g_rows, wf // S, S, -1).reshape(
                g_rows, wf, -1
            )
        r_abs = g * g_rows + row_in_g  # (g_rows, 1) global row index
        limit = jnp.where(
            r_abs < n_rows,
            jnp.clip(bound - start - r_abs * wf, 0, wf),
            0,
        )  # (g_rows, 1) valid windows per row
        return jnp.sum(
            match & (col < limit)[:, :, None], axis=(0, 1), dtype=jnp.int32
        )

    parts = jax.lax.map(one_group, (grouped, jnp.arange(G, dtype=jnp.int32)))
    counts = jnp.sum(parts, axis=0, dtype=jnp.int32)
    if p_out > counts.shape[0]:
        counts = jnp.pad(counts, (0, p_out - counts.shape[0]))
    return counts


@functools.partial(
    jax.jit, static_argnames=("wf", "fold", "g_rows", "stride", "p_out")
)
def scan_corr_batch(
    rows: jax.Array,  # (R, wf + halo) uint8 — folded rows, MANY corpora
    kern: jax.Array,  # (m_max + S - 1, B, P*S) bf16 — shift-folded kernel
    thr: jax.Array,  # (P*S,) f32 — per-channel match thresholds (= m_p)
    alph: jax.Array,  # (C,) uint8 — pattern alphabet
    limits: jax.Array,  # (R,) int32 — valid windows per row (precomputed)
    *,
    wf: int,
    fold: int,  # rows per batch block (R % fold == 0)
    g_rows: int,  # rows per mapped group (static)
    stride: int = 1,  # shift-fold stride S (see pick_stride)
    p_out: int = 0,  # zero-pad the pattern axis to this length
):
    """Batched k = 0 correlation scan: per-BLOCK counts ``(R//fold,
    max(P, p_out)) int32`` — the same contract as
    ``apm.ops.pallas_kernel.scan_folded_pallas_batch``, so
    ``Scanner.count_batch`` can route eligible k = 0 batches through the
    conv (the reference's many-pattern serving shape is one CUDA thread
    per pattern, ``src/database_over_ranks.cu:26-29``; here extra
    patterns are extra output channels of one conv).

    Window ownership arrives PRE-RESOLVED as ``limits[r]`` (the caller
    owns the virtual-window-space bookkeeping: ``clip(bound - start -
    i*wf, 0, wf)`` per row, 0 for padding rows), so the scan itself has
    no notion of corpora — it counts ``match & (col < limit)`` per row
    and folds rows back to blocks.
    """
    R, L = rows.shape
    S = stride
    assert wf % S == 0 and R % fold == 0, (wf, S, R, fold)
    G = -(-R // g_rows)
    pad = G * g_rows - R
    if pad:
        rows = jnp.pad(rows, ((0, pad), (0, 0)))
        limits = jnp.pad(limits, (0, pad))
    grouped = rows.reshape(G, g_rows, L)
    lim_g = limits.reshape(G, g_rows)
    col = jnp.arange(wf, dtype=jnp.int32)[None, :]

    def one_group(args):
        rg, lim = args  # (g_rows, L) uint8, (g_rows,) int32
        t = _encode_planes(rg, alph, kern.shape[1])
        corr = _conv(t, kern, S)
        match = corr[:, : wf // S, :] >= thr[None, None, :]
        if S > 1:  # block jb, channel s*P+p  ->  window jb*S + s
            match = match.reshape(g_rows, wf // S, S, -1).reshape(
                g_rows, wf, -1
            )
        return jnp.sum(
            match & (col < lim[:, None])[:, :, None],
            axis=1,
            dtype=jnp.int32,
        )  # (g_rows, P)

    parts = jax.lax.map(one_group, (grouped, lim_g))  # (G, g_rows, P)
    per_row = parts.reshape(G * g_rows, -1)[:R]
    counts = jnp.sum(
        per_row.reshape(R // fold, fold, -1), axis=1, dtype=jnp.int32
    )
    if p_out > counts.shape[1]:
        counts = jnp.pad(counts, ((0, 0), (0, p_out - counts.shape[1])))
    return counts


# ---------------------------------------------------------------------------
# Conv phase 1 for pigeonhole filtration (k >= 1).
#
# A window within distance k has at least one error-free piece (pigeonhole),
# and exact piece matching is the same correlation as above with patterns
# replaced by pieces. Phase 1 only needs ROW-level candidacy (verification
# is row-granular), so the sound reduction is simply "any piece of pattern
# p hits anywhere in the row (+halo)" — a superset of a per-window
# drift-consistent shift test, exact after verification. The halo contract round_up(m_max + 2k, 128) provably
# covers every drifted piece position: the furthest piece start is
# wf-1 + (m_p - l_last) + k and pieces within a pattern differ by at most
# one byte in length, so coverage reduces to k + 1 + l_last >= w_kern,
# which holds with w_kern = l_last(+1) of the longest pattern.

def build_piece_kernel(
    pat_raw: np.ndarray, plens, k: int, alphabet, stride: int = 1
):
    """Piece-correlation tables for conv phase 1.

    Returns ``(kern (w_kern + stride - 1, B, N*stride) bf16,
    thr (N*stride,) f32, owner (N, P) f32)`` where N is the total piece
    count across patterns, ``B = n_bitplanes(C)``, and ``owner`` is the
    piece->pattern one-hot used to combine piece hits into per-pattern
    row maps with one small matmul. Pieces are exact-tier (kp = 0), so
    the ±1 bit-plane certificate applies verbatim: a piece hits iff its
    correlation reaches ``B * length``. ``stride`` shift-folds the
    kernel (see :func:`pick_stride`); pass the same value to
    :func:`scan_pieces_conv`.
    """
    from .filtration import pieces_of_j, tier_of

    P, m_max = pat_raw.shape
    B = n_bitplanes(len(alphabet))
    pieces = []  # (pattern index, offset, length)
    for pi in range(P):
        m = plens[pi]
        if m == 0:
            continue
        j, kp = tier_of(m, k)
        assert kp == 0, "conv phase 1 is exact-tier only"
        for off, length in pieces_of_j(m, j):
            pieces.append((pi, off, length))
    n = len(pieces)
    w_kern = max(length for _, _, length in pieces)
    kern = np.zeros((w_kern, B, n), dtype=np.float32)
    thr = np.zeros((n,), dtype=np.float32)
    owner = np.zeros((n, P), dtype=np.float32)
    for ni, (pi, off, length) in enumerate(pieces):
        thr[ni] = B * length
        owner[ni, pi] = 1.0
        for i in range(length):
            ci = int(np.searchsorted(alphabet, pat_raw[pi, off + i]))
            for b in range(B):
                kern[i, b, ni] = 1.0 if (ci >> b) & 1 else -1.0
    kern, thr = _fold_shifts(kern, thr, stride)
    return kern.astype(jnp.bfloat16), thr, owner


@functools.partial(
    jax.jit, static_argnames=("wf", "w_kern", "n_rows", "g_rows", "stride")
)
def scan_pieces_conv(
    rows: jax.Array,  # (R, wf + halo) uint8 — folded staged corpus rows
    kern: jax.Array,  # (w_kern, B, N*S) bf16 — ±1 bit-plane piece kernel
    thr: jax.Array,  # (N*S,) f32 — per-piece thresholds (= piece lengths)
    owner: jax.Array,  # (N, P) f32 — piece -> pattern one-hot
    alph: jax.Array,  # (C,) uint8 — pattern alphabet
    bound: jax.Array,  # () int32 — global window bound (exclusive)
    start: jax.Array,  # () int32 — global window index of row 0
    *,
    wf: int,
    w_kern: int,  # FULL kernel width = base piece width + stride - 1
    n_rows: int,
    g_rows: int,
    stride: int = 1,  # shift-fold stride S (see pick_stride)
):
    """Conv phase 1: ``(fcnt (P,) int32, rowmap (R, P) int32)``.

    ``fcnt`` counts piece hits per pattern in rows that own at least one
    valid window — a conservative candidate proxy (0 iff no candidates,
    which is all the phase-2 decision tree needs). ``rowmap`` flags rows
    with any piece hit; rows owning no valid window (past ``bound`` or
    group padding) are masked so they can never go hot.

    With ``stride = S > 1`` (shift-folded kernel from
    :func:`build_piece_kernel`): row-level candidacy must see piece hits
    at EVERY stride-1 position up to ``L - base_wk`` (the halo positions
    cover drifted pieces of windows owned near the row end), so the text
    is zero-padded by ``S - 1`` columns, making the strided blocks cover
    ``[0, B*S)`` ⊇ all base positions. The <= S - 1 overshoot positions
    read zero padding and can only fire for all-NUL pieces — a
    conservative (sound) superset; phase 2 verifies exactly.
    """
    R, L = rows.shape
    S = stride
    G = -(-R // g_rows)
    pad = G * g_rows - R
    if pad:
        rows = jnp.pad(rows, ((0, pad), (0, 0)))
    grouped = rows.reshape(G, g_rows, L)
    row_in_g = jnp.arange(g_rows, dtype=jnp.int32)[:, None]

    def one_group(args):
        rg, g = args
        if S > 1:
            rg = jnp.pad(rg, ((0, 0), (0, S - 1)))
        t = _encode_planes(rg, alph, kern.shape[1])
        corr = _conv(t, kern, S)  # (g_rows, (L + S - 1 - w_kern)//S + 1, N*S)
        hit = corr >= thr[None, None, :]
        r_abs = g * g_rows + row_in_g  # (g_rows, 1)
        live = jnp.logical_and(
            r_abs < n_rows, start + r_abs * wf < bound
        )  # (g_rows, 1): row owns >= 1 valid window
        hits_n = jnp.sum(
            hit & live[:, :, None], axis=1, dtype=jnp.float32
        )  # (g_rows, N*S) piece-hit counts per row
        if S > 1:  # fold the shift copies back onto the base pieces
            hits_n = jnp.sum(
                hits_n.reshape(g_rows, S, -1), axis=1, dtype=jnp.float32
            )
        # exact: f32 sums of small integers, kept out of TF32
        rowpat = jnp.matmul(
            hits_n, owner, precision=jax.lax.Precision.HIGHEST
        )  # (g_rows, P)
        return rowpat

    parts = jax.lax.map(
        one_group, (grouped, jnp.arange(G, dtype=jnp.int32))
    )  # (G, g_rows, P)
    rowpat = parts.reshape(G * g_rows, -1)[:R]
    fcnt = jnp.sum(rowpat, axis=0, dtype=jnp.int32)
    return fcnt, (rowpat > 0).astype(jnp.int32)
