"""Shared helpers for the scan engines."""

from __future__ import annotations

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cap_for(k: int) -> int:
    """DP clamp value. ``min(dist, k+1)`` preserves the ``dist <= k`` verdict.

    Clamping commutes with the min-plus Levenshtein recurrence: if every input
    cell holds ``min(true, k+1)``, then ``min(min3(inputs)+cost, k+1)`` equals
    ``min(true_output, k+1)`` — proved by monotonicity of min/plus. This keeps
    every DP cell in ``[0, k+1]`` regardless of pattern length.
    """
    return k + 1


def pad_corpus(buf: np.ndarray, n_pad: int, halo: int) -> np.ndarray:
    """Zero-pad the corpus to ``n_pad + halo`` bytes (device block layout)."""
    out = np.zeros(n_pad + halo, dtype=np.uint8)
    out[: len(buf)] = buf
    return out


def fold_corpus(
    buf: np.ndarray, offset: int, n_rows: int, wf: int, halo: int
) -> np.ndarray:
    """Stage the corpus into overlapping rows for the device engines.

    Row ``r`` holds bytes ``buf[offset + r*wf : offset + r*wf + wf + halo)``,
    zero-padded past EOF. The ~``halo/wf`` duplication makes every row a
    self-contained unit of work: each row's windows can be scanned,
    gathered (phase-2 verification) or sharded without touching another
    row.
    """
    try:
        from ..utils import native

        if native.available():
            return native.fold(buf, offset, n_rows, wf, halo)
    except Exception:
        pass
    flat = np.zeros(n_rows * wf + halo, dtype=np.uint8)
    avail = max(0, min(len(buf) - offset, n_rows * wf + halo))
    if avail > 0:
        flat[:avail] = buf[offset : offset + avail]
    rows = np.lib.stride_tricks.as_strided(
        flat, shape=(n_rows, wf + halo), strides=(wf, 1)
    )
    return np.ascontiguousarray(rows)
