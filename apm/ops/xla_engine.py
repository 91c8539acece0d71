"""The plain XLA banded-DP engine (pure jnp, no Pallas).

The clamped banded Levenshtein recurrence as a ``lax.fori_loop`` over DP
steps, with the whole ``(patterns, windows)`` batch advanced in lockstep as
array ops. Two entry shapes share :func:`_band_capture`:

* :func:`band_rows_xla` — staged corpus rows with a per-row
  ``(bound, start)`` table: the DP step of the scan pipeline on the CPU
  (``apm.ops.pallas_kernel.resolve_impl``), and what the Triton kernel is
  timed against on the GPU;
* :func:`scan_block_xla` / :func:`scan_corpus_xla` — a flat corpus with the
  reference's EOF truncation: the plain reference the kernel is checked
  against (the reference's CPU path analog, ``src/utils.c:76-99`` + the
  OpenMP window loops).

Semantics (identical to apm.utils.oracle, i.e. to sequential.c):
window starts ``j in [0, n-k)``; per-window truncated length
``size = min(m, n-j)``; match iff clamped banded distance <= k.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .common import cap_for

# Byte budget of band_rows_xla's live (2k+3, P, rows, wf) int32 state per
# mapped row group.
XLA_BAND_BYTES = 64 << 20


def _band_capture(text_at, pat, sizes, shape, *, k: int, m_max: int):
    """Plain XLA banded DP: clamped ``D[size][size]`` for every window.

    ``text_at(x)`` gives the text byte of DP step ``x`` for every window
    (broadcastable to ``shape``, whose leading axis is the pattern axis);
    ``sizes`` (broadcastable to ``shape``) is each window's capture length.
    Cells are clamped at ``k + 1`` (``cap_for``), which keeps the
    ``<= k`` verdict exact.
    """
    p = pat.shape[0]
    cap = jnp.int32(cap_for(k))
    bw = 2 * k + 1
    tail = (1,) * (len(shape) - 1)
    band0 = jnp.stack(
        [
            jnp.full(shape, d if d >= 0 else cap, jnp.int32)
            for d in range(-k, k + 1)
        ]
    )  # (2k+1, *shape); row x=0 init: D[0][y] = y
    res0 = jnp.full(shape, cap, jnp.int32)

    def step(x, carry):
        band, res = carry
        tx = text_at(x)
        px = jax.lax.dynamic_slice(pat, (0, x - 1), (p, bw))  # (P, 2k+1)
        new_rows = []
        prev = jnp.full(shape, cap, jnp.int32)  # insertion chain
        for di in range(bw):
            d = di - k
            c = (px[:, di].reshape((p,) + tail) != tx).astype(jnp.int32)
            sub = band[di] + c
            dele = (band[di + 1] if d < k else jnp.full(shape, cap)) + 1
            val = jnp.minimum(jnp.minimum(sub, dele), prev + 1)
            # boundary column D[x][0] = x (cell y = x + d == 0, x <= k)
            val = jnp.where(x + d == 0, x.astype(jnp.int32), val)
            val = jnp.minimum(val, cap)
            new_rows.append(val)
            prev = val
        band = jnp.stack(new_rows)
        res = jnp.where(sizes == x, band[k], res)  # capture D[size][size]
        return band, res

    _, res = jax.lax.fori_loop(1, m_max + 1, step, (band0, res0))
    return res


def band_rows_xla(rows, pat, plen, meta, *, k, m_max, wf):
    """The plain XLA band over staged rows: ``(R, P, wf)`` bool verdicts.

    Rows are mapped in groups sized by :data:`XLA_BAND_BYTES`, so the
    live band state stays bounded at any corpus size."""
    r_rows = rows.shape[0]
    p = pat.shape[0]
    g = max(1, min(r_rows, XLA_BAND_BYTES // ((2 * k + 3) * p * wf * 4)))
    n_g = -(-r_rows // g)
    pad = n_g * g - r_rows
    if pad:  # padding rows carry bound 0: every window invalid
        rows = jnp.pad(rows, ((0, pad), (0, 0)))
        meta = jnp.pad(meta, ((0, pad), (0, 0)))
    sizes = plen.astype(jnp.int32).reshape(p, 1, 1)
    lane = jnp.arange(wf, dtype=jnp.int32)[None, :]

    def one_group(args):
        rg, mg = args  # (g, wf + halo) uint8, (g, 2) int32

        def text_at(x):
            return jax.lax.dynamic_slice(rg, (0, x - 1), (g, wf))[None]

        res = _band_capture(
            text_at, pat, sizes, (p, g, wf), k=k, m_max=m_max
        )
        valid = mg[:, 1:2] + lane < mg[:, 0:1]  # (g, wf)
        hits = jnp.logical_and(res <= k, valid[None])  # (P, g, wf)
        return jnp.transpose(hits, (1, 0, 2))

    out = jax.lax.map(
        one_group,
        (rows.reshape(n_g, g, -1), meta.reshape(n_g, g, 2)),
    )
    return out.reshape(n_g * g, p, wf)[:r_rows]


@functools.partial(jax.jit, static_argnames=("k", "m_max"))
def scan_block_xla(
    text: jax.Array,  # (V + m_max,) uint8 — V windows + halo bytes (zero-padded)
    pat: jax.Array,  # (P, m_max + 2k) uint8 — k-padded pattern table
    plen: jax.Array,  # (P,) int32 pattern lengths (0 = padding row)
    start: jax.Array,  # () int32 — absolute window index of text[0]
    n: jax.Array,  # () int32 — total corpus bytes
    *,
    k: int,
    m_max: int,
) -> jax.Array:
    """Per-pattern match counts over the V window starts of this block."""
    v = text.shape[0] - m_max
    p = pat.shape[0]
    w = jax.lax.broadcasted_iota(jnp.int32, (1, v), 1)  # (1, V) window offsets
    abs_w = start.astype(jnp.int32) + w  # (1, V) absolute window starts
    sizes = jnp.minimum(
        plen.astype(jnp.int32)[:, None], n.astype(jnp.int32) - abs_w
    )  # (P, V)
    n_windows = jnp.maximum(n.astype(jnp.int32) - k, 0)
    valid = abs_w < n_windows  # (1, V)

    def text_at(x):
        return jax.lax.dynamic_slice(text, (x - 1,), (v,))[None, :]

    res = _band_capture(text_at, pat, sizes, (p, v), k=k, m_max=m_max)
    matches = jnp.logical_and(res <= k, valid)
    return jnp.sum(matches, axis=1, dtype=jnp.int32)  # (P,)


@functools.partial(jax.jit, static_argnames=("k", "m_max", "v"))
def scan_corpus_xla(
    corpus: jax.Array,  # (n_pad + m_max,) uint8 zero-padded corpus
    pat: jax.Array,  # (P, m_max + 2k) uint8
    plen: jax.Array,  # (P,) int32
    n: jax.Array,  # () int32 true corpus length
    start: jax.Array = 0,  # () int32 global window index of corpus[0]
    *,
    k: int,
    m_max: int,
    v: int,
) -> jax.Array:
    """Whole-corpus scan: fori over chunks of ``v`` windows on-device."""
    n_pad = corpus.shape[0] - m_max
    assert n_pad % v == 0, "corpus must be padded to a multiple of the chunk width"
    num_chunks = n_pad // v
    p = pat.shape[0]
    start = jnp.asarray(start, jnp.int32)

    def body(i, acc):
        blk = jax.lax.dynamic_slice(corpus, (i * v,), (v + m_max,))
        return acc + scan_block_xla(
            blk, pat, plen, start + (i * v).astype(jnp.int32), n,
            k=k, m_max=m_max,
        )

    return jax.lax.fori_loop(0, num_chunks, body, jnp.zeros((p,), jnp.int32))
