"""Shared scan-pipeline orchestration.

The single source of truth the three count entry points
(``Scanner._count_pipeline``, ``strategies.count_database_over_devices``,
``multihost.count_multihost``) share:

* :class:`ScanPlan` / :func:`make_plan` — every derived layout quantity
  (block width, halo, window bound) and every routing choice (engine,
  pattern partition, how the DP step runs) computed in exactly one place;
* :func:`finalize_filtration` — the phase-2 decision tree (zero-candidate
  skip, density fallback, on-device verified counts, overflow recovery,
  clipped-row verification) over per-chunk results from
  ``apm.ops.fused.filter_verify_chunk_conv``;
* :func:`verify_rows_host` — the host-staged verification used only when
  a chunk overflows its on-device hot-row bucket.

Corpus access is abstracted as a ``reader(j0, length) -> np.ndarray``
(zero-padded past EOF) so the in-memory and file-backed (multihost) paths
share the verification code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, TYPE_CHECKING

import numpy as np

from ..ops.common import round_up
from ..ops.pallas_kernel import DPStep

if TYPE_CHECKING:  # pragma: no cover
    from .scanner import Scanner

Reader = Callable[[int, int], np.ndarray]


def buf_reader(buf: np.ndarray) -> Reader:
    """Reader over an in-memory corpus; zero-pads past EOF."""

    def read(j0: int, length: int) -> np.ndarray:
        seg = buf[j0 : j0 + length]
        if len(seg) == length:
            return np.asarray(seg)
        out = np.zeros(length, dtype=np.uint8)
        out[: len(seg)] = seg
        return out

    return read


def file_reader(path: str) -> Reader:
    """Reader over an on-disk corpus (native range reads; zero-padded)."""
    import os

    from ..utils import native

    path = os.fspath(path)

    def read(j0: int, length: int) -> np.ndarray:
        if native.available():
            return native.read_range(path, j0, length)
        out = np.zeros(length, dtype=np.uint8)
        with open(path, "rb") as f:
            f.seek(j0)
            data = np.frombuffer(f.read(length), dtype=np.uint8)
        out[: len(data)] = data
        return out

    return read


@dataclass(frozen=True)
class ScanPlan:
    """Derived layout for one scan: the quantities every path must agree on."""

    dp: DPStep  # how the banded DP step runs (kernel or plain XLA band)
    w: int  # block windows (ROWS_PER_BLOCK staging rows)
    wf: int  # windows per staging row
    halo: int  # staging-row overlap >= m_max + 2k, lane-aligned
    dev_bound: int  # exclusive bound of device-owned window starts
    engine: str  # "auto" / "dp" / "corr"
    fmask: tuple  # per-pattern: True when filtration takes it
    plens_filter: tuple  # static lengths routed to filtration (k >= 1)
    plens_dp: tuple  # static lengths routed to the banded DP
    use_corr: bool = False  # k = 0 correlation engine takes the scan
    plens_corr: tuple = ()  # static lengths routed to the corr engine

    @property
    def any_filter(self) -> bool:
        return any(self.plens_filter)

    @property
    def any_dp(self) -> bool:
        return any(self.plens_dp)


def make_plan(scanner: "Scanner", n: int) -> ScanPlan:
    """Compute the scan layout and routing. ONE place for both.

    Routing follows the input alone — ``k``, pattern lengths, pattern
    count and alphabet: k = 0 sets the correlation can take run the
    correlation engine; at k >= 1 the patterns the piece correlation can
    take (:func:`apm.ops.filtration.partition_plens`) run filtration
    phase 1 + verification; everything else runs the banded DP. The only
    platform fact, how the DP step runs, is ``scanner.dp_step()``.

    The halo must satisfy every engine's contract: the banded DP needs
    ``halo >= m_max - 1`` bytes of lookahead, the piece correlation
    ``halo >= m_max + 2k`` (drifted pieces of windows owned near the row
    end) — so ``round_up(m_max + 2k, 128)`` everywhere.
    """
    from ..ops.corr_engine import ALPHABET_MAX, M_MAX_CORR, corr_eligible
    from ..ops.filtration import partition_plens
    from ..parallel.plan import ROWS_PER_BLOCK

    k = scanner.k
    w = round_up(scanner.block_windows_for(n), ROWS_PER_BLOCK * 128)
    engine = scanner.config.engine
    alphabet_size = len(scanner._corr_alphabet())
    common = dict(
        dp=scanner.dp_step(),
        w=w,
        wf=w // ROWS_PER_BLOCK,
        halo=round_up(scanner.m_max + 2 * k, 128),
        dev_bound=scanner.device_window_bound(n),
    )
    # k = 0: exact matching is a correlation — the conv engine takes the
    # WHOLE pattern set when eligible. "auto" opts in past the measured
    # crossover; "corr" demands it.
    use_corr = k == 0 and engine in ("auto", "corr") and corr_eligible(
        scanner._plens_static, alphabet_size, scanner.m_max, k,
        auto=engine == "auto",
    )
    if engine == "corr" and not use_corr:
        raise ValueError(
            "engine='corr' requires k == 0, a pattern alphabet of <= "
            f"{ALPHABET_MAX} distinct bytes, and m_max <= {M_MAX_CORR}"
        )
    if use_corr:
        zeros = tuple(0 for _ in scanner._plens_static)
        return ScanPlan(
            engine="corr",
            fmask=tuple(False for _ in scanner._plens_static),
            plens_filter=zeros,
            plens_dp=zeros,
            use_corr=True,
            plens_corr=scanner._plens_static,
            **common,
        )
    fmask, plens_filter, plens_dp = partition_plens(
        scanner._plens_static, k, engine, alphabet_size
    )
    return ScanPlan(
        engine=engine,
        fmask=fmask,
        plens_filter=plens_filter,
        plens_dp=plens_dp,
        **common,
    )


@dataclass
class FilterChunk:
    """Per-chunk/per-shard fused filtration results (device handles until
    :func:`finalize_filtration` fetches the tiny ones)."""

    c0: int  # global window start of the chunk/shard
    fcnt: object  # (P,) candidate totals (device or np); None when the
    # psum'd total is carried by another chunk (sharded paths)
    vcnt: object  # (P,) on-device verified counts (device or np); None as above
    n_hot: object  # () or int — true full-hot-row count
    clip_starts: object  # (MAX_CLIP,) global starts of clipped hot rows
    rowmap: object = None  # (R, P) device handle, or a fetch callable, or None
    verify_dev: object = None  # callable(n_hot) -> list of (P,) device count
    # handles re-verifying ALL this chunk's full hot rows ON DEVICE
    # (apm.ops.fused.count_hot_batch), or None past the compaction cap.
    # Attaching it asserts this chunk's ``vcnt`` is CHUNK-LOCAL (the
    # single-device loop) — sharded paths carry psum'd totals and must
    # leave it None.


def candidate_density_dense(hot_rows: int, wf: int, dev_bound: int) -> bool:
    """The shared density threshold: when verification would touch more
    windows than ~5% of the corpus (or 64 rows minimum), rescanning the
    filtration patterns with the banded DP is cheaper than targeted
    verification. Not measured on the H100."""
    return hot_rows * wf > max(64 * wf, dev_bound // 20)


def finalize_filtration(
    scanner: "Scanner",
    reader: Reader,
    plan: ScanPlan,
    n: int,
    chunks: Sequence[FilterChunk],
    rescan: Callable[[], np.ndarray],
    *,
    max_hot: int,
) -> np.ndarray:
    """Phase-2 decision tree over fused per-chunk results (k >= 1).

    Returns the (p_pad,) int64 exact-match counts for the filtration
    patterns. ``rescan()`` must return banded-DP counts for
    ``plan.plens_filter`` over the whole device-owned range (the density /
    overflow fallback). A chunk's ``rowmap`` may be ``None`` when the row
    map cannot be fetched (multihost with non-addressable shards) — then
    overflow falls back to ``rescan()`` too.
    """
    k = scanner.k
    p_pad = scanner._pat.shape[0]
    out = np.zeros((p_pad,), dtype=np.int64)
    assert k >= 1

    # One synchronization point: fetch every chunk's tiny outputs together
    # (dispatch already happened asynchronously during the chunk loop).
    fcnt = np.zeros((p_pad,), dtype=np.int64)
    vcnt = np.zeros((p_pad,), dtype=np.int64)
    n_hots: List[int] = []
    clips: List[int] = []
    for ch in chunks:
        if ch.fcnt is not None:
            fcnt += np.asarray(ch.fcnt, dtype=np.int64)
        if ch.vcnt is not None:
            vcnt += np.asarray(ch.vcnt, dtype=np.int64)
        n_hots.append(int(np.asarray(ch.n_hot)))
        clips.extend(
            int(j0) for j0 in np.asarray(ch.clip_starts).ravel() if j0 >= 0
        )
    clips = sorted(set(clips))

    if int(fcnt.sum()) == 0:
        return out  # zero candidates: nothing to verify, nothing to add

    hot_total = sum(n_hots) + len(clips)
    if candidate_density_dense(hot_total, plan.wf, plan.dev_bound):
        return rescan().astype(np.int64)

    overflow = [(ch, h) for ch, h in zip(chunks, n_hots) if h > max_hot]
    if overflow:
        # Preferred recovery: re-verify each overflowed chunk's hot rows
        # ON DEVICE (count_hot_batch over the resident staging + row map)
        # — chunk-local vcnt of non-overflow chunks is kept, overflow
        # chunks are replaced by their batch sums. One extra fetch total.
        dev_batches = None
        if all(ch.verify_dev is not None for ch, _ in overflow):
            dev_batches = [(ch, ch.verify_dev(h)) for ch, h in overflow]
            if any(b is None for _, b in dev_batches):
                dev_batches = None  # a chunk exceeded the compaction cap
        if dev_batches is not None:
            import jax.numpy as jnp

            handles = [h for _, batches in dev_batches for h in batches]
            fetched = np.asarray(jnp.stack(handles))  # (B, P) one fetch
            redone = {id(ch) for ch, _ in overflow}
            for ch, h in zip(chunks, n_hots):
                if id(ch) not in redone:
                    out += np.asarray(ch.vcnt, dtype=np.int64)
            bi = 0
            for ch, batches in dev_batches:
                nb = len(batches)
                out += fetched[bi : bi + nb].sum(axis=0, dtype=np.int64)
                bi += nb
        elif any(ch.rowmap is None for ch, _ in overflow):
            return rescan().astype(np.int64)
        else:
            # Host-staged fallback: verify ALL full hot rows (the psum'd
            # on-device vcnt can't be split per chunk, so it is discarded
            # wholesale).
            rows: List[int] = []
            for ch in chunks:
                rm = (
                    ch.rowmap() if callable(ch.rowmap) else np.asarray(ch.rowmap)
                )
                for r in np.nonzero(rm.any(axis=1))[0]:
                    j0 = ch.c0 + int(r) * plan.wf
                    if j0 + plan.wf <= plan.dev_bound:
                        rows.append(j0)
            out += verify_rows_host(
                scanner, reader, n, sorted(set(rows)), plan
            )
    else:
        out += vcnt

    # Clipped rows (at most one per chunk): banded verification over the
    # partial row, host-side, for patterns that have candidates at all.
    for j0 in clips:
        out += _verify_clipped_row(scanner, reader, plan, n, j0, fcnt)
    return out


def verify_rows_host(
    scanner: "Scanner",
    reader: Reader,
    n: int,
    rows: Sequence[int],
    plan: ScanPlan,
) -> np.ndarray:
    """Host-staged verification of full hot rows (overflow recovery).

    Rows are staged into one (bucket, wf + halo) array and verified with a
    single banded-DP call over all filtration patterns.
    """
    import jax.numpy as jnp

    from ..ops.fused import ROW_ALIGN
    from ..ops.pallas_kernel import dp_count

    p_pad = scanner._pat.shape[0]
    out = np.zeros((p_pad,), dtype=np.int64)
    if not rows:
        return out
    wf, halo = plan.wf, plan.halo
    n_hot = len(rows)
    bucket = max(ROW_ALIGN, round_up(n_hot, 4 * ROW_ALIGN))
    stage = np.zeros((bucket, wf + halo), dtype=np.uint8)
    for i, j0 in enumerate(rows):
        stage[i] = reader(j0, wf + halo)
    dev = dp_count(
        jnp.asarray(stage),
        jnp.asarray(scanner._pat),
        jnp.asarray(n_hot * wf, jnp.int32),
        jnp.asarray(0, jnp.int32),
        k=scanner.k, m_max=scanner.m_max, wf=wf, plens=plan.plens_filter,
        dp=plan.dp,
    )
    out += np.asarray(dev)
    return out


def _verify_clipped_row(
    scanner: "Scanner",
    reader: Reader,
    plan: ScanPlan,
    n: int,
    j0: int,
    fcnt: np.ndarray,
) -> np.ndarray:
    """Verify the window-bound-clipped hot row [j0, dev_bound) host-side."""
    from ..utils import native
    from ..utils.oracle import banded_distances

    k = scanner.k
    p_pad = scanner._pat.shape[0]
    out = np.zeros((p_pad,), dtype=np.int64)
    j1 = min(j0 + plan.wf, plan.dev_bound)
    if j0 >= j1:
        return out
    use_native = native.available()
    for pi, is_f in enumerate(plan.fmask):
        if not is_f or fcnt[pi] == 0:
            continue
        pat = scanner.scan_patterns.raw[pi]
        seg = reader(j0, min(n - j0, j1 - j0 + len(pat) - 1 + k))
        if use_native:
            out[pi] += native.banded_count(
                seg, np.frombuffer(pat, np.uint8), k, j1 - j0, -1
            )
        else:
            d = banded_distances(seg, pat, k)
            out[pi] += int(np.sum(d[: j1 - j0] <= k))
    return out
