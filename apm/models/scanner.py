"""End-to-end scan pipeline: the framework's "model".

Where the reference wires CLI -> cost model -> MPI strategy -> OMP -> kernel
(src/main.c:30-156), here one Scanner owns: pattern packing, corpus staging,
the scan plan (apm.models.pipeline.make_plan: engine routing and how the DP
step runs), chunking, and — when more than one device is visible — the
distribution plan (apm.parallel).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import jax
import numpy as np

from ..ops.common import fold_corpus, round_up
from ..utils.config import ApmConfig
from ..utils.io import PatternSet
from ..utils.oracle import Bytes, as_u8


class Scanner:
    """Counts, for each pattern, the windows within edit distance <= k.

    Usage::

        sc = Scanner(["GATTACA", "CCCTTT"], k=2)
        counts = sc.count(corpus_bytes)   # np.ndarray (P,) int64
    """

    def __init__(
        self,
        patterns: Sequence[Bytes],
        k: int,
        config: Optional[ApmConfig] = None,
    ):
        if k < 0:
            raise ValueError("approx factor k must be >= 0")
        self.k = int(k)
        self.config = (config or ApmConfig()).validate()
        self.patterns = PatternSet.from_patterns(patterns)
        self.m_max = self.patterns.max_len

        # Deduplicate patterns: identical patterns share one scan and the
        # counts are expanded afterwards. (The reference scans each duplicate
        # separately — its own smoke test sends the same 50-char line five
        # times, README.md:54-91.)
        raw = list(self.patterns.raw)
        if self.config.dedup_patterns:
            uniq: List[bytes] = []
            index = {}
            inverse = []
            for r in raw:
                if r not in index:
                    index[r] = len(uniq)
                    uniq.append(r)
                inverse.append(index[r])
            self._inverse = np.asarray(inverse, dtype=np.int64)
        else:
            uniq = raw
            self._inverse = np.arange(len(raw), dtype=np.int64)
        self.scan_patterns = PatternSet.from_patterns(uniq)

        pat_packed, plen = self.scan_patterns.packed(self.k)
        # Pad the pattern axis to a multiple of 8 (fewer distinct compiled
        # shapes); padding rows have length 0 and generate no DP work.
        p_pad = max(8, round_up(self.scan_patterns.num_patterns, 8))
        self._pat = np.zeros((p_pad, pat_packed.shape[1]), dtype=np.uint8)
        self._pat[: pat_packed.shape[0]] = pat_packed
        self._plen = np.zeros((p_pad,), dtype=np.int32)
        self._plen[: plen.shape[0]] = plen
        self._plens_static = tuple(int(x) for x in self._plen)
        # Raw (un-k-padded) table for the correlation engines.
        self._pat_raw = np.zeros((p_pad, self.m_max), dtype=np.uint8)
        self._pat_raw[: self.scan_patterns.num_patterns] = (
            self.scan_patterns.table
        )
        self.last_duration: Optional[float] = None
        from ..utils.profiling import Meter

        self.meter = Meter()
        self.last_strategy: Optional[str] = None
        self.last_plan = None  # the ScanPlan of the last count()
        # Device-resident staged-corpus cache: (fingerprint, wf, halo,
        # chunk_win, c0) -> device array of folded rows.
        self._dev_cache: dict = {}
        # Optional SHARED host-side fold cache (same key -> folded np
        # rows): set on pattern-shard sub-scanners so the corpus is
        # folded once per chunk instead of once per device
        # (count_patterns_over_devices replicates the corpus on every
        # device; only the h2d transfer is inherently per-device).
        self._fold_cache: Optional[dict] = None
        import threading

        # Guards _fold_cache insert/evict; replaced by the PARENT's lock
        # when a shared fold cache is attached (_pattern_shard_scanners),
        # so all sub-scanners serialize on one lock.
        self._fold_cache_lock = threading.Lock()
        # Guards _dev_cache mutation and iteration: the background prewarm
        # thread (warmup's purge) runs concurrently with foreground scans'
        # _staged_rows insert/evict, and dict iteration during a
        # concurrent pop raises RuntimeError.
        self._dev_cache_lock = threading.RLock()
        # id -> (weakref, fp) memo for immutable buffers (_corpus_fp).
        self._fp_memo: dict = {}
        self._prewarm_thread = None
        if self.config.prewarm_bytes:
            self._prewarm_thread = threading.Thread(
                target=self._prewarm_run,
                args=(int(self.config.prewarm_bytes),),
                name="apm-prewarm",
                daemon=True,
            )
            self._prewarm_thread.start()

    def _prewarm_run(self, corpus_bytes: int) -> None:
        try:
            self.warmup(corpus_bytes)
        except Exception as e:  # startup helper: never take the service down
            from ..utils.profiling import info

            info(f"prewarm failed (scans will compile lazily): {e!r}")

    def prewarm_join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the background prewarm (``ApmConfig.prewarm_bytes``).

        Returns True when the prewarm has finished (or none was requested).
        """
        t = self._prewarm_thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def _corr_alphabet(self) -> np.ndarray:
        """Distinct pattern bytes (cached) — the corr engine's channels."""
        a = getattr(self, "_corr_alph", None)
        if a is None:
            from ..ops.corr_engine import build_alphabet

            a = self._corr_alph = build_alphabet(self.scan_patterns.raw)
        return a

    def dp_step(self):
        """How this scanner's banded DP step runs (cached): the Triton
        kernel or the plain XLA band, decided in ONE place
        (``apm.ops.pallas_kernel.resolve_dp_step``), plus the bit-parallel
        (Myers) mode's alphabet when that mode is on."""
        dp = getattr(self, "_dp", None)
        if dp is None:
            from ..ops.pallas_kernel import resolve_dp_step

            dp = self._dp = resolve_dp_step(
                k=self.k,
                m_max=self.m_max,
                n_pat=self._pat.shape[0],
                alphabet=tuple(int(b) for b in self._corr_alphabet()),
                dp_impl=self.config.dp_impl,
                backend=self.config.backend,
                interpret=self.config.interpret,
            )
        return dp

    def _corr_kernel(self):
        """Shift-folded ±1 conv kernel for the corr engine (cached):
        ``(kern, thr, stride)`` — pass ``stride`` to ``scan_corr_conv``.

        Built over the REAL pattern rows only: pattern-table padding rows
        would add all-zero kernel columns that still cost multiply-adds
        and shrink the shift-fold stride. The scan pads its count vector
        back to ``p_pad`` (``p_out``).
        """
        kk = getattr(self, "_corr_kern", None)
        if kk is None:
            from ..ops.corr_engine import build_kernel, pick_stride

            n_real = self.scan_patterns.num_patterns
            stride = pick_stride(n_real)
            kern, thr = build_kernel(
                self._pat_raw[:n_real],
                self._plens_static[:n_real],
                self._corr_alphabet(),
                stride=stride,
            )
            kk = self._corr_kern = (kern, thr, stride)
        return kk

    def _corr_call(
        self, drows, dbound, dstart, *, wf, halo, n_rows, p_out
    ):
        """One k = 0 correlation chunk scan (``scan_corr_conv``)."""
        from ..ops.corr_engine import _group_rows, scan_corr_conv

        alph = self._corr_alphabet()
        kern_np, thr_np, corr_stride = self._corr_kernel()
        return scan_corr_conv(
            drows, jax.numpy.asarray(kern_np), jax.numpy.asarray(thr_np),
            jax.numpy.asarray(alph), dbound, dstart,
            wf=wf, m_max=self.m_max, n_rows=n_rows,
            g_rows=_group_rows(wf + halo, len(alph), n_rows),
            stride=corr_stride, p_out=p_out,
        )

    def _fp1_kernel(self, plens_filter: tuple):
        """Piece-correlation tables for filtration phase 1 (cached per
        split): ``(kern, thr, owner, stride)``."""
        cached = getattr(self, "_fp1_cache", None)
        if cached is not None and cached[0] == plens_filter:
            return cached[1]
        from ..ops.corr_engine import build_piece_kernel, pick_stride
        from ..ops.filtration import tier_of

        n_pieces = sum(
            tier_of(m, self.k)[0] for m in plens_filter if m > 0
        )
        stride = pick_stride(n_pieces)
        tables = build_piece_kernel(
            self._pat_raw, plens_filter, self.k, self._corr_alphabet(),
            stride=stride,
        ) + (stride,)
        self._fp1_cache = (plens_filter, tables)
        return tables

    def _fp1_call(
        self, drows, dpat, dbound, dstart, plan, *, n_rows, max_hot
    ):
        """One phase-1 + phase-2 filtration chunk call
        (``fused.filter_verify_chunk_conv``): ``(packed, rowmap)``."""
        from ..ops.corr_engine import _group_rows
        from ..ops.fused import filter_verify_chunk_conv

        wf, halo = plan.wf, plan.halo
        alph = self._corr_alphabet()
        pk_np, pt_np, ow_np, fp1_stride = self._fp1_kernel(
            plan.plens_filter
        )
        return filter_verify_chunk_conv(
            drows, jax.numpy.asarray(pk_np), jax.numpy.asarray(pt_np),
            jax.numpy.asarray(ow_np), jax.numpy.asarray(alph),
            dpat, dbound, dstart,
            k=self.k, m_max=self.m_max, wf=wf, plens=plan.plens_filter,
            w_kern=pk_np.shape[0], n_rows=n_rows,
            g_rows=_group_rows(wf + halo, len(alph), n_rows),
            fp1_stride=fp1_stride, max_hot=max_hot, dp=plan.dp,
        )

    @staticmethod
    def _immutable(buf) -> bool:
        """True when no numpy handle can mutate ``buf``'s bytes: every
        ndarray in the base chain is non-writeable (a read-only *view* of
        a writeable array does NOT qualify — writes through the base
        would still change the content under the view)."""
        obj = buf
        while isinstance(obj, np.ndarray):
            if obj.flags.writeable:
                return False
            obj = obj.base
        return True

    def _corpus_fp(self, buf: np.ndarray):
        """Content fingerprint for the device-corpus cache, memoized for
        immutable buffers.

        The full-content hash runs at ~12 GB/s but still costs ~21 ms of
        a 60 ms steady-state 256 MB scan (bench/fp1_probe.py item 7).
        When the buffer is provably immutable (:meth:`_immutable` — e.g.
        ``count_file``'s read-only memmap, or any array the caller
        ``setflags(write=False)``-froze), the hash is computed once and
        memoized by object identity; a weakref guards against a recycled
        ``id`` ever aliasing a different array. Writable buffers are
        re-hashed every call — an in-place mutation must change the key.

        CONTRACT: freezing a buffer is a promise it will never change
        again. Thawing a scanned frozen buffer with
        ``setflags(write=True)``, mutating it in place, and re-freezing
        it is UNSUPPORTED (use a fresh array, or leave the buffer
        writable and pay the per-call re-hash): the memo validates hits
        with a sampled check (:meth:`_fp_sample`) that catches coarse
        content swaps but — necessarily, or it would be the full hash —
        not arbitrary localized mutations, and a hit then serves counts
        for the old content. Documented in ``ApmConfig.cache_corpus``.
        """
        if not self.config.cache_corpus:
            return None
        if isinstance(buf, np.ndarray) and self._immutable(buf):
            import weakref

            key = id(buf)
            ent = self._fp_memo.get(key)
            if ent is not None and ent[0]() is buf and (
                ent[2] == self._fp_sample(buf)
            ):
                # Sample check: an array thawed with setflags(write=True),
                # mutated, and re-frozen keeps its id but (almost surely)
                # not its boundary/stride sample — recompute on mismatch
                # instead of serving a stale fingerprint.
                return ent[1]
            fp = self._fingerprint(buf)
            try:
                ref = weakref.ref(
                    buf, lambda _, k=key: self._fp_memo.pop(k, None)
                )
                self._fp_memo[key] = (ref, fp, self._fp_sample(buf))
            except TypeError:
                pass
            return fp
        return self._fingerprint(buf)

    @staticmethod
    def _fp_sample(buf: np.ndarray) -> tuple:
        """Cheap content sample validating `_fp_memo` hits: length plus
        64 bytes at each of 33 evenly spaced offsets (~2 KB, O(1), no
        full pass). This catches coarse content changes (a swapped or
        re-sliced buffer, a bulk overwrite) — NOT arbitrary localized
        mutations of a thawed-and-refrozen buffer, which the memo
        contract excludes (see :meth:`_corpus_fp`)."""
        n = buf.size
        if n == 0:
            return (0,)
        flat = buf.reshape(-1)
        parts = [n]
        for i in range(33):
            off = (n - 1) * i // 32
            parts.append(flat[off:off + 64].tobytes())
        return tuple(parts)

    @staticmethod
    def _fingerprint(buf: np.ndarray) -> tuple:
        """Full-content fingerprint for the device-corpus cache.

        Hashes EVERY byte (native MurmurHash64A pass at several GB/s, or
        BLAKE2b via the buffer protocol as fallback) so any content change
        — including a localized in-place mutation — changes the key.
        A sampled fingerprint could silently serve stale counts; the full
        pass costs a few ms per 100 MB, far below the host→device transfer
        it saves on a hit.
        """
        from ..utils import native

        n = len(buf)
        if native.available():
            return (n, native.hash_bytes(buf))
        import hashlib

        arr = np.ascontiguousarray(buf, dtype=np.uint8)
        return (n, hashlib.blake2b(memoryview(arr), digest_size=8).hexdigest())

    # -- single-device scan ---------------------------------------------------

    def device_window_bound(self, n: int) -> int:
        """Exclusive bound of device-owned window starts.

        The device scans untruncated windows ``j <= n - m_max``; the <=
        ``m_max - 1`` EOF-truncated windows (``sequential.c:131-134``) are
        counted host-side by :meth:`tail_counts` — they are too few to
        matter and removing them from the kernel removes a per-step
        ``(P, W)`` compare.
        """
        return max(0, min(n - self.m_max + 1, n - self.k))

    def tail_counts(self, buf: np.ndarray, dev_bound: int) -> np.ndarray:
        """Oracle counts for the EOF tail windows ``j in [dev_bound, n-k)``.

        Returned per *scan* (deduplicated) pattern.
        """
        n = len(buf)
        p = self.scan_patterns.num_patterns
        out = np.zeros((p,), dtype=np.int64)
        if dev_bound >= max(n - self.k, 0):
            return out
        suffix = buf[dev_bound:]
        nw = max(0, len(suffix) - self.k)
        try:
            from ..utils import native

            if native.available():
                for i, raw in enumerate(self.scan_patterns.raw):
                    out[i] = native.banded_count(
                        suffix,
                        np.frombuffer(raw, np.uint8),
                        self.k,
                        nw,
                        len(suffix),
                    )
                return out
        except Exception:
            pass
        from ..utils.oracle import count_matches

        out[:] = count_matches(suffix, list(self.scan_patterns.raw), self.k)
        return out

    def block_windows_for(self, n: int) -> int:
        """Kernel block width: explicit config or the planner's choice."""
        if self.config.block_windows is not None:
            return self.config.block_windows
        from ..parallel.plan import choose_block_windows

        return choose_block_windows(
            max(n - self.k, 0),
            self.m_max,
            self.scan_patterns.num_patterns,
            self.k,
        )

    def _cache_byte_budget(self) -> int:
        """Byte cap for the device-corpus LRU: explicit config, or a
        quarter of the device's reported HBM (round 1 capped by entry
        *count*, which could pin ~8 GB at the default chunk size)."""
        if self.config.cache_bytes is not None:
            return self.config.cache_bytes
        try:
            stats = jax.devices()[0].memory_stats()
            limit = int(stats.get("bytes_limit", 0)) if stats else 0
        except Exception:
            limit = 0
        return limit // 4 if limit > 0 else 4 << 30

    def _staged_rows(self, buf, fp, c0, n_rows, wf, halo):
        """Device-resident folded staging rows for one chunk (LRU-cached,
        byte-bounded)."""
        key = (fp, wf, halo, n_rows, c0)
        if fp is not None:
            with self._dev_cache_lock:
                if key in self._dev_cache:
                    # mark recent
                    self._dev_cache[key] = self._dev_cache.pop(key)
                    return self._dev_cache[key]
        fc = self._fold_cache
        rows = fc.get(key) if (fc is not None and fp is not None) else None
        if rows is None:
            rows = fold_corpus(buf, c0, n_rows, wf, halo)
            if fc is not None and fp is not None:
                # Shared across pattern-shard sub-scanners running in a
                # ThreadPoolExecutor: insert + evict under the shared lock
                # so two threads can't pop the same key.
                with self._fold_cache_lock:
                    fc[key] = rows
                    while len(fc) > 4:  # bound host memory to ~4 chunks
                        try:
                            fc.pop(next(iter(fc)), None)
                        except StopIteration:  # pragma: no cover
                            break
        drows = jax.numpy.asarray(rows)
        if fp is not None:
            budget = self._cache_byte_budget()
            if drows.nbytes <= budget:
                with self._dev_cache_lock:
                    self._dev_cache[key] = drows
                    total = sum(
                        v.nbytes for v in self._dev_cache.values()
                    )
                    while total > budget and len(self._dev_cache) > 1:
                        old = self._dev_cache.pop(
                            next(iter(self._dev_cache))
                        )
                        total -= old.nbytes
        return drows

    def _count_pipeline(
        self, buf: np.ndarray, n: int, fp: object = "auto"
    ) -> np.ndarray:
        """Single-device scan: correlation / filtration / banded DP, chunked.

        :func:`apm.models.pipeline.make_plan` routes the patterns: a k = 0
        set the correlation takes runs ``scan_corr_conv``; at k >= 1 the
        patterns the piece correlation takes run filtration phase 1 +
        on-device phase 2 (``apm.ops.fused.filter_verify_chunk_conv``), the
        rest run the banded DP (``apm.ops.pallas_kernel.dp_count``). The
        chunk loop only *dispatches* — all device results are fetched
        together afterwards, so no per-chunk host synchronization — and the
        phase-2 decision tree (density fallback, overflow recovery, clipped
        rows) is the shared :func:`apm.models.pipeline.finalize_filtration`.

        The host-side chunk loop keeps every chunk the same compiled shape
        (the window bound masks the last chunk's padding), so one jit
        compilation serves arbitrarily large corpora — and accumulating
        counts per chunk host-side is checkpoint/resume for free
        (SURVEY.md §5).
        """
        from ..ops.fused import count_hot_batch, pick_max_hot, unpack_chunk
        from ..ops.pallas_kernel import dp_count
        from .pipeline import (
            FilterChunk,
            buf_reader,
            finalize_filtration,
            make_plan,
        )

        k = self.k
        plan = make_plan(self, n)
        self.last_plan = plan
        wf, halo, dev_bound = plan.wf, plan.halo, plan.dev_bound
        p_pad = self._pat.shape[0]
        counts = np.zeros((p_pad,), dtype=np.int64)
        if dev_bound <= 0:
            counts[: self.scan_patterns.num_patterns] += self.tail_counts(
                buf, dev_bound
            )
            return counts

        chunk_win = self._chunk_windows(plan)
        n_rows = chunk_win // wf
        max_hot = pick_max_hot(n_rows, wf, plan.plens_filter, k)
        dpat = jax.numpy.asarray(self._pat)
        dbound = jax.numpy.asarray(dev_bound, dtype=np.int32)
        if fp == "auto":
            fp = self._corpus_fp(buf)

        def dp_chunk(drows, c0, plens):
            return dp_count(
                drows, dpat, dbound, jax.numpy.asarray(c0, dtype=np.int32),
                k=k, m_max=self.m_max, wf=wf, plens=plens, dp=plan.dp,
            )

        handles = []  # (P,)-shaped device counts, fetched after the loop
        raw_chunks = []  # (c0, packed handle, rowmap handle, rows)
        for c0 in range(0, dev_bound, chunk_win):
            drows = self._staged_rows(buf, fp, c0, n_rows, wf, halo)
            dc0 = jax.numpy.asarray(c0, dtype=np.int32)
            if plan.use_corr:
                handles.append(
                    self._corr_call(
                        drows, dbound, dc0,
                        wf=wf, halo=halo, n_rows=n_rows, p_out=p_pad,
                    )
                )
            if plan.any_dp:
                handles.append(dp_chunk(drows, c0, plan.plens_dp))
            if plan.any_filter:
                packed, rowmap = self._fp1_call(
                    drows, dpat, dbound, dc0, plan,
                    n_rows=n_rows, max_hot=max_hot,
                )
                raw_chunks.append((c0, packed, rowmap, drows))

        # ONE device->host fetch for all per-chunk vectors.
        small = list(handles) + [pk for _, pk, _, _ in raw_chunks]
        fetched = (
            np.asarray(jax.numpy.concatenate([s.ravel() for s in small]))
            if small
            else np.zeros((0,), dtype=np.int64)
        )
        off = 0
        for h in handles:
            counts += fetched[off : off + p_pad]
            off += p_pad

        def make_verify_dev(drows, rowmap, c0):
            """Device-side overflow recovery for one chunk: batch count
            handles over ALL its full hot rows (fused.count_hot_batch);
            None past the compaction cap (host fallback)."""

            from ..ops import fused

            n_batch, cap = fused.OVERFLOW_BATCH, fused.OVERFLOW_CAP

            def verify(n_hot: int):
                if n_hot > cap:
                    return None
                nb = -(-n_hot // n_batch)
                return [
                    count_hot_batch(
                        drows, rowmap, dpat, dbound,
                        jax.numpy.asarray(c0, dtype=np.int32),
                        jax.numpy.asarray(b, dtype=np.int32),
                        k=k, m_max=self.m_max, wf=wf,
                        plens=plan.plens_filter,
                        n_batch=n_batch, cap=cap, dp=plan.dp,
                    )
                    for b in range(nb)
                ]

            return verify

        fchunks = []
        for c0, pk, rowmap, drows in raw_chunks:
            ln = pk.shape[0]
            fcnt, vcnt, n_hot, clip = unpack_chunk(
                fetched[off : off + ln], p_pad
            )
            off += ln
            fchunks.append(
                FilterChunk(
                    c0, fcnt, vcnt, n_hot, clip, rowmap,
                    verify_dev=make_verify_dev(drows, rowmap, c0),
                )
            )

        if fchunks:

            def rescan() -> np.ndarray:
                out = np.zeros((p_pad,), dtype=np.int64)
                for c0 in range(0, dev_bound, chunk_win):
                    drows = self._staged_rows(buf, fp, c0, n_rows, wf, halo)
                    out += np.asarray(dp_chunk(drows, c0, plan.plens_filter))
                return out

            counts += finalize_filtration(
                self, buf_reader(buf), plan, n, fchunks, rescan,
                max_hot=max_hot,
            )

        counts[: self.scan_patterns.num_patterns] += self.tail_counts(
            buf, dev_bound
        )
        return counts

    def _chunk_windows(self, plan) -> int:
        """Windows per host-loop chunk: ``chunk_bytes`` rounded to whole
        blocks, at most the device-owned range."""
        return max(
            plan.w,
            round_up(min(self.config.chunk_bytes, plan.dev_bound), plan.w),
        )

    def _pattern_shard_scanners(
        self, groups, block_windows: Optional[int] = None
    ) -> List["Scanner"]:
        """Sub-scanners over pattern index groups (patterns_over_devices).

        Cached on the parent so repeated ``count()`` calls reuse each
        sub-scanner's device-resident corpus cache and compiled kernels.
        ``block_windows`` pins every group to ONE block width so their
        staging layouts (wf, halo) agree and the shared host fold cache
        can serve all devices from a single ``fold_corpus`` pass.
        """
        key = (tuple(tuple(g) for g in groups), block_windows)
        if getattr(self, "_shard_scanners_key", None) == key:
            return self._shard_scanners
        from dataclasses import replace

        # prewarm_bytes must not propagate: each sub-scanner would spawn a
        # background warmup thread compiling + dispatching mid-scan.
        cfg = replace(
            self.config,
            strategy="single",
            dedup_patterns=False,
            prewarm_bytes=None,
            block_windows=block_windows or self.config.block_windows,
        )
        subs = [
            Scanner([self.scan_patterns.raw[i] for i in g], self.k, cfg)
            for g in groups
        ]
        fold_cache: dict = {}
        for sub in subs:
            sub._fold_cache = fold_cache
            sub._fold_cache_lock = self._fold_cache_lock
        self._shard_scanners_key = key
        self._shard_scanners = subs
        return subs

    # -- public API ------------------------------------------------------------

    def warmup(
        self,
        corpus_bytes: int,
        paths: Sequence[str] = ("count", "find", "batch"),
    ) -> None:
        """Ahead-of-time compile the kernels for a given corpus size.

        First-time compilation of a (k, pattern-length multiset, block
        width) combination takes seconds; call this once at service
        startup (with the expected corpus size) so the first real scan
        runs at full speed. Executes one zero-filled block of the exact
        shapes the scan will use; results land in the persistent compile
        cache when one is configured (``apm.utils.compile_cache``).

        ``paths`` selects which serving entry points to warm:

        * ``"count"`` — the :meth:`count` programs (filtration / banded /
          corr / overflow-recovery), zero-filled blocks of exact shapes;
        * ``"find"`` — :meth:`find`'s position programs
          (``sweep_positions_chunk`` and the overflow
          ``gather_mask_rows``), warmed by driving the real
          entry point on a zero corpus of ``corpus_bytes`` (identical
          shapes to a real call) plus one direct overflow-batch call;
        * ``"batch"`` — :meth:`count_batch`'s grouped kernel, warmed on a
          one-corpus batch of ``corpus_bytes`` (covers any batch big
          enough to hit the group bucket cap; smaller batches bucket
          differently and compile on first use).

        Corpus-cache entries staged by the warm runs are purged so the
        zero corpus never occupies the device cache budget.
        """
        if "count" in paths:
            self._warmup_count(int(corpus_bytes))
        if "find" in paths or "batch" in paths:
            self._warmup_serving(int(corpus_bytes), paths)

    def _warmup_serving(self, n: int, paths: Sequence[str]) -> None:
        """Drive find()/count_batch on a zero corpus to absorb their
        compiles (see :meth:`warmup`), leaving the corpus caches as they
        were.

        The purge is scoped by the zero corpus's FINGERPRINT (every
        ``_dev_cache``/``_fold_cache`` key carries the fp first), not a
        bare before/after key diff: warmup may run on the background
        prewarm thread concurrently with real foreground scans, and a
        key diff would evict whatever the foreground scan staged
        meanwhile. Within that fp scope, keys already present BEFORE the
        warm runs are additionally spared — a foreground corpus that is
        itself all zeros of the same length shares the content
        fingerprint, and its previously staged rows must survive the
        warmup (a same-fp key staged DURING the warm runs
        is indistinguishable from warmup's own and is purged — it is
        byte-identical staging the foreground can restage on a miss).
        The zero buffer is writable, so ``_corpus_fp`` never memoizes it
        — no ``_fp_memo`` cleanup is needed (round 4 cleared the whole
        memo here, dropping real corpora's memoized fingerprints).
        """
        zeros = np.zeros((n,), dtype=np.uint8)
        warm_fp = (
            self._fingerprint(zeros) if self.config.cache_corpus else None
        )
        if warm_fp is not None:
            with self._dev_cache_lock:
                dev_pre = {
                    k2 for k2 in self._dev_cache if k2[0] == warm_fp
                }
            fold_pre = set()
            if self._fold_cache is not None:
                with self._fold_cache_lock:
                    fold_pre = {
                        k2 for k2 in self._fold_cache if k2[0] == warm_fp
                    }
        try:
            if "find" in paths:
                self.find(zeros)
                self._warmup_gather(n)
            if "batch" in paths:
                self.count_batch([zeros])
        finally:
            if warm_fp is not None:
                with self._dev_cache_lock:
                    for key in [
                        k2
                        for k2 in self._dev_cache
                        if k2[0] == warm_fp and k2 not in dev_pre
                    ]:
                        self._dev_cache.pop(key, None)
                if self._fold_cache is not None:
                    with self._fold_cache_lock:
                        for key in [
                            k2
                            for k2 in self._fold_cache
                            if k2[0] == warm_fp and k2 not in fold_pre
                        ]:
                            self._fold_cache.pop(key, None)

    def _warmup_gather(self, n: int) -> None:
        """Compile find()'s overflow-batch program (``gather_mask_rows``)
        for the exact shapes :meth:`find` dispatches at corpus size
        ``n`` — a zero-corpus drive never overflows, so this one is
        warmed directly."""
        from ..ops.fused import FIND_BATCH, POS_CAP, gather_mask_rows
        from .pipeline import make_plan

        plan = make_plan(self, n)
        if plan.dev_bound <= 0:
            return
        n_rows = self._chunk_windows(plan) // plan.wf
        rows = jax.numpy.zeros(
            (n_rows, plan.wf + plan.halo), jax.numpy.uint8
        )
        idx = jax.numpy.full((FIND_BATCH,), n_rows, jax.numpy.int32)
        posmeta, _bits = gather_mask_rows(
            rows, idx, jax.numpy.asarray(self._pat),
            jax.numpy.asarray(0, np.int32),
            k=self.k, m_max=self.m_max, wf=plan.wf,
            plens=self._plens_static,
            p_real=self.scan_patterns.num_patterns, dp=plan.dp,
            pos_cap=POS_CAP,
        )
        np.asarray(posmeta)

    def _warmup_count(self, n: int) -> None:
        from ..ops.fused import count_hot_batch, pick_max_hot
        from ..ops.pallas_kernel import dp_count
        from .pipeline import make_plan

        k = self.k
        plan = make_plan(self, n)
        wf, halo, dev_bound = plan.wf, plan.halo, plan.dev_bound
        if dev_bound <= 0:
            return
        n_rows = self._chunk_windows(plan) // wf
        zero32 = jax.numpy.asarray(0, jax.numpy.int32)
        rows = jax.numpy.zeros((n_rows, wf + halo), jax.numpy.uint8)
        dpat = jax.numpy.asarray(self._pat)
        if plan.use_corr:
            np.asarray(
                self._corr_call(
                    rows, zero32, zero32,
                    wf=wf, halo=halo, n_rows=n_rows,
                    p_out=self._pat.shape[0],
                )
            )
        if plan.any_dp:
            np.asarray(
                dp_count(
                    rows, dpat, zero32, zero32, k=k, m_max=self.m_max,
                    wf=wf, plens=plan.plens_dp, dp=plan.dp,
                )
            )
        if plan.any_filter:
            max_hot = pick_max_hot(n_rows, wf, plan.plens_filter, k)
            packed, rowmap = self._fp1_call(
                rows, dpat, zero32, zero32, plan,
                n_rows=n_rows, max_hot=max_hot,
            )
            np.asarray(packed)
            # Overflow-recovery batch program (count_hot_batch): the batch
            # index is traced, so this one execution compiles the program
            # any overflowed scan will dispatch.
            np.asarray(
                count_hot_batch(
                    rows, rowmap, dpat, zero32, zero32, zero32,
                    k=k, m_max=self.m_max, wf=wf,
                    plens=plan.plens_filter, dp=plan.dp,
                )
            )

    def find(self, corpus: Bytes, limit: Optional[int] = None):
        """Match *positions*, not just counts — beyond the reference's API.

        Returns a list (one entry per input pattern) of int64 arrays of
        window starts ``j`` with ``lev(pattern, corpus[j:j+m]) <= k``
        (untruncated and EOF-truncated windows alike, same semantics as
        :meth:`count`). ``limit`` caps positions per pattern.

        Implementation: every pattern resolves positions ON DEVICE, one
        ``sweep_positions_chunk`` call per chunk (the banded verdict-mask
        sweep, per-row position compaction, hot-row re-verification). The
        host fetches one small meta vector plus compacted positions per
        chunk, and a bit-packed verdict mask only when a row holds more
        hits than the compaction cap. Only the (at most one per chunk)
        window-bound-clipped row and the EOF tail run the host oracle.
        """
        from ..ops.fused import (
            FIND_BATCH,
            MAX_CLIP,
            POS_CAP,
            gather_mask_rows,
            sweep_positions_chunk,
            unpack_mask_bits,
        )
        from ..utils.oracle import banded_distances
        from .pipeline import make_plan

        buf = as_u8(corpus)
        n = len(buf)
        k = self.k
        nw = max(n - k, 0)
        p_all = self.scan_patterns.num_patterns
        uniq_positions = [np.zeros((0,), dtype=np.int64) for _ in range(p_all)]
        if nw > 0:
            plan = make_plan(self, n)
            plens = self._plens_static
            dev_bound = plan.dev_bound
            dev_positions = {pi: [] for pi in range(p_all)}  # np arrays
            clip_ranges = []  # bound-clipped hot rows -> host oracle
            if dev_bound > 0:
                wf, halo = plan.wf, plan.halo
                n_rows = self._chunk_windows(plan) // wf
                fp = self._corpus_fp(buf)
                # pos_cap is read at call time (module attr) and is part
                # of the jit static key, so a changed cap can never reuse
                # a trace compiled for a different position-vector size.
                kw = dict(
                    k=k, m_max=self.m_max, wf=wf, plens=plens, p_real=p_all,
                    dp=plan.dp, pos_cap=POS_CAP,
                )
                dpat = jax.numpy.asarray(self._pat)
                dbound = jax.numpy.asarray(dev_bound, dtype=np.int32)

                def collect(bits_np, rows_np, c0):
                    """Append positions from a fetched bit-packed mask."""
                    for pi in range(p_all):
                        m01 = unpack_mask_bits(bits_np, pi, len(rows_np))
                        hh, ll = np.nonzero(m01[:, :wf])
                        if len(hh):
                            dev_positions[pi].append(
                                c0 + rows_np[hh].astype(np.int64) * wf + ll
                            )

                def collect_rows(pos2, cnts, rows_np, c0):
                    """Append positions from per-row device top-k
                    compaction (fused._row_topk_positions): ``pos2``
                    (nb, c) flat indices into (p, wf), ``cnts`` exact
                    per-row hit counts, ``rows_np`` the rows' global
                    staging indices. Rows with cnt > c are skipped (the
                    caller routes them through the mask fallback)."""
                    valid = (pos2 >= 0) & (cnts <= pos2.shape[1])[:, None]
                    b, _s = np.nonzero(valid)
                    if not len(b):
                        return
                    v = pos2[valid].astype(np.int64)
                    pis = v // wf
                    base = c0 + rows_np.astype(np.int64)[b] * wf + v % wf
                    for pi in range(p_all):
                        seg = base[pis == pi]
                        if len(seg):
                            dev_positions[pi].append(seg)

                def collect_batch(posmeta_like, bits, rows_np, c0):
                    """One verdict-mask batch: the per-row count+position
                    vector, or the packed mask when some row overflowed
                    POS_CAP (bits stays on device until then)."""
                    pm = np.asarray(posmeta_like)
                    cnts = pm[:FIND_BATCH]
                    pos2 = pm[FIND_BATCH:].reshape(FIND_BATCH, -1)
                    rows_full = np.zeros(FIND_BATCH, dtype=np.int64)
                    rows_full[: len(rows_np)] = rows_np
                    if int(cnts.max(initial=0)) > pos2.shape[1]:
                        collect(np.asarray(bits), rows_np, c0)
                    else:
                        collect_rows(pos2, cnts, rows_full, c0)

                def gather_batches(hot, drows, c0):
                    """Re-verify ``hot`` (global full hot rows, ascending)
                    via gather_mask_rows batches, all dispatched before
                    the first fetch."""
                    r_rows = drows.shape[0]
                    batches, handles = [], []
                    for b0 in range(0, len(hot), FIND_BATCH):
                        batch = hot[b0 : b0 + FIND_BATCH]
                        bidx = np.full(FIND_BATCH, r_rows, dtype=np.int32)
                        bidx[: len(batch)] = batch
                        batches.append(batch)
                        handles.append(
                            gather_mask_rows(
                                drows, jax.numpy.asarray(bidx), dpat,
                                jax.numpy.asarray(len(batch), dtype=np.int32),
                                **kw,
                            )
                        )
                    pms = jax.device_get([pm for pm, _ in handles])
                    for batch, pm_h, (_, bb) in zip(batches, pms, handles):
                        collect_batch(pm_h, bb, batch, c0)

                def finish(drows, c0, meta, pos, gpos, bits, rowmap):
                    mv = np.asarray(meta)  # host array when pre-fetched
                    fcnt = mv[: len(plens)]
                    n_hot = int(mv[len(plens)])
                    i0 = len(plens) + 1
                    idx = mv[i0 : i0 + FIND_BATCH]
                    tailcnt = mv[i0 + FIND_BATCH : i0 + 2 * FIND_BATCH]
                    cs0 = i0 + 2 * FIND_BATCH
                    clip_starts = mv[cs0 : cs0 + MAX_CLIP]
                    gcnt = mv[cs0 + MAX_CLIP :]  # per-row full-row hits
                    clip_ranges.extend(
                        (int(cs), min(int(cs) + wf, dev_bound))
                        for cs in clip_starts
                        if cs >= 0
                    )
                    if int(fcnt.sum()) == 0:
                        return
                    r_rows = drows.shape[0]
                    if n_hot > FIND_BATCH:
                        # Dense regime: ONE gpos fetch replaces the tail
                        # verdicts and every gather batch; only rows past
                        # POS_CAP re-verify.
                        gp = np.asarray(gpos)
                        collect_rows(
                            gp, gcnt, np.arange(r_rows, dtype=np.int64), c0
                        )
                        over = np.nonzero(gcnt > gp.shape[1])[0]
                        if len(over):
                            gather_batches(over, drows, c0)
                        return
                    n_first = min(n_hot, FIND_BATCH)
                    if n_first > 0:
                        if int(tailcnt.max(initial=0)) > POS_CAP:
                            collect(np.asarray(bits), idx[:n_first], c0)
                        else:
                            rows_full = np.zeros(FIND_BATCH, dtype=np.int64)
                            rows_full[:n_first] = idx[:n_first]
                            collect_rows(np.asarray(pos), tailcnt, rows_full, c0)

                def flush(entries):
                    """Fetch every entry's (meta, pos) in ONE batched
                    device-to-host copy, then run the per-entry tail; the
                    conditional fetches (bits / gpos / gather batches) stay
                    lazy and fire only on overflow."""
                    if not entries:
                        return
                    fetched = jax.device_get([(e[2], e[3]) for e in entries])
                    for e, (mv_h, pos_h) in zip(entries, fetched):
                        finish(e[0], e[1], mv_h, pos_h, e[4], e[5], e[6])

                # Dispatch chunks ahead of the fetches (async). The window
                # bounds how many chunks' staging rows stay referenced at
                # once; on overflow the OLDER half flushes in one batched
                # fetch while the newer half keeps computing.
                ahead = 4
                pending = []
                for c0 in range(0, dev_bound, n_rows * wf):
                    drows = self._staged_rows(buf, fp, c0, n_rows, wf, halo)
                    dc0 = jax.numpy.asarray(c0, dtype=np.int32)
                    # n_batch mirrors the module constant so the host meta
                    # parse and the programs' static layout can't drift
                    # (and tests can shrink it).
                    meta, pos, gpos, bits, rowmap = sweep_positions_chunk(
                        drows, dpat, dbound, dc0, n_batch=FIND_BATCH, **kw
                    )
                    pending.append((drows, c0, meta, pos, gpos, bits, rowmap))
                    if len(pending) > ahead:
                        half = max(1, len(pending) // 2)
                        flush(pending[:half])
                        del pending[:half]
                flush(pending)
            for pi, raw in enumerate(self.scan_patterns.raw):
                pat = np.frombuffer(raw, np.uint8)
                if dev_bound > 0:
                    # device positions + clipped rows + the EOF tail
                    ranges = list(clip_ranges)
                    if dev_bound < nw:
                        ranges.append((dev_bound, nw))
                else:
                    ranges = [(0, nw)]  # corpus shorter than one pattern
                found = list(dev_positions[pi])
                m = len(pat)
                for j0, j1 in ranges:
                    if j0 >= j1:
                        continue
                    # Untruncated ranges only need m-1+k context bytes;
                    # a range reaching the EOF tail keeps the true end so
                    # the truncation quirk applies.
                    end = n if j1 > dev_bound else min(n, j1 + m - 1 + k)
                    d = banded_distances(buf[j0:end], pat, k)
                    hits = np.nonzero(d[: j1 - j0] <= k)[0] + j0
                    found.append(hits)
                pos = (
                    np.concatenate(found).astype(np.int64)
                    if found
                    else np.zeros((0,), dtype=np.int64)
                )
                # Segments are generated ascending and disjoint (chunks in
                # order, rows ascending within a chunk, the <= 1 clipped
                # row and the EOF tail last and past all device windows),
                # so the concatenation is normally already sorted-unique —
                # checking is O(n), the sort it avoids dominated dense
                # sweeps.
                if len(pos) > 1 and not np.all(pos[1:] > pos[:-1]):
                    pos = np.unique(pos)
                if limit is not None:
                    pos = pos[:limit]
                uniq_positions[pi] = pos
        return [uniq_positions[i] for i in self._inverse]

    def count_file(self, path) -> np.ndarray:
        """Scan a corpus file without slurping it into memory.

        The file is memory-mapped read-only; the chunked scan loop then
        touches pages on demand (the native staging routines memcpy
        straight out of the mapping), so corpora larger than RAM stream
        through at page-cache speed. Counts are identical to
        ``count(read_input_file(path))``.
        """
        import os

        buf = np.memmap(os.fspath(path), dtype=np.uint8, mode="r")
        return self.count(buf)

    def count_stream(
        self,
        chunks,
        *,
        segment_bytes: Optional[int] = None,
    ) -> np.ndarray:
        """Scan a corpus delivered incrementally, without materializing it.

        ``chunks`` is any iterable of byte chunks (a socket reader, a pipe,
        a generator over an object store…). Counts are identical to
        ``count(b"".join(chunks))`` — including the reference's
        EOF-truncation quirk, which is only applied at the true end of the
        stream — while peak memory stays at one segment
        (``segment_bytes``, default ``config.chunk_bytes``) plus the
        ``m_max - 1 + k`` carry bytes that windows straddling a segment
        boundary need.

        Exactness without a range-scan kernel: for a working buffer ``B``
        the mid-stream segment owns windows ``[0, hi)`` with
        ``hi = device_window_bound(len(B))`` (every such window is
        untruncated and provably below the final ``n - k`` bound), and

            counts[0, hi) == count(B) - count(B[hi:])

        because ``count`` applies the same EOF-truncation semantics to the
        identical trailing windows of both calls — the wrong-mid-stream
        tail counts cancel bit-exactly. The suffix re-scan costs one
        ``m_max - 1 + k``-byte host pass per segment, noise next to the
        segment scan. The reference slurps the whole file up front
        (``src/utils.c:12-68``) and has no streaming story.
        """
        p = self.patterns.num_patterns
        total = np.zeros((p,), dtype=np.int64)
        seg = int(segment_bytes or self.config.chunk_bytes)
        seg = max(seg, 4 * max(self.m_max + self.k, 1))
        # Segments are never re-scanned, so route them through a sibling
        # scanner with the device-corpus cache off — otherwise every
        # segment's staged rows would churn the byte-bounded LRU and evict
        # hot resident corpora served by concurrent count() calls. The
        # sibling shares the compiled kernels (jit caches by shape), so
        # this costs nothing.
        sib = getattr(self, "_stream_scanner", None)
        if sib is None and self.config.cache_corpus:
            from dataclasses import replace

            sib = self._stream_scanner = Scanner(
                list(self.patterns.raw),
                self.k,
                replace(self.config, cache_corpus=False, prewarm_bytes=None),
            )
        count = sib.count if sib is not None else self.count
        parts, pending = [], 0  # buffered chunks (one concat per segment)
        for chunk in chunks:
            b = as_u8(chunk)
            if len(b) == 0:
                continue
            parts.append(b)
            pending += len(b)
            while pending >= seg:
                carry = (
                    np.concatenate(parts) if len(parts) > 1 else parts[0]
                )
                hi = self.device_window_bound(len(carry))
                if hi <= 0:
                    parts, pending = [carry], len(carry)
                    break
                total += count(carry)
                total -= count(carry[hi:])
                parts, pending = [carry[hi:]], len(carry) - hi
        if pending:
            total += count(
                np.concatenate(parts) if len(parts) > 1 else parts[0]
            )
        return total

    def count_batch(self, corpora: Sequence[Bytes]) -> np.ndarray:
        """Scan MANY corpora in few device dispatches: (B, P) counts.

        Semantics are exactly ``np.stack([count(c) for c in corpora])``,
        but every corpus's device-owned windows are staged as rows of one
        shared row table, each row carrying its own corpus's window bound
        (the kernel's per-row ``(bound, start)`` meta), so a group of rows
        from many corpora is ONE call of the banded DP
        (``apm.ops.pallas_kernel.dp_scan``); per-row counts are summed back
        per corpus host-side. The serving analog the reference lacks
        entirely (its unit of work is one process launch per database,
        ``src/main.c:30-60``).

        Engine: eligible k = 0 batches run the correlation
        (``apm.ops.corr_engine.scan_corr_batch``, per-row counts) — the
        many-pattern regime where the banded DP is weakest (the
        reference's analog is one CUDA thread per pattern,
        ``src/database_over_ranks.cu:26-29``). Everything else uses the
        banded DP; filtration stays out of batch mode — its win is on
        large corpora, which belong in :meth:`count`.
        """
        from ..ops.common import fold_corpus
        from ..ops.pallas_kernel import dp_scan
        from .pipeline import make_plan

        bufs = [as_u8(c) for c in corpora]
        B = len(bufs)
        p_out = self.patterns.num_patterns
        out = np.zeros((B, p_out), dtype=np.int64)
        if B == 0:
            return out
        plan = make_plan(self, max(len(b) for b in bufs))
        wf, halo = plan.wf, plan.halo
        p_pad = self._pat.shape[0]

        # Stage every corpus's device-owned windows as whole rows; each
        # row records its corpus, its window start and its corpus's bound.
        staged, owner, meta = [], [], []
        bounds = []
        for b, buf in enumerate(bufs):
            db = self.device_window_bound(len(buf))
            bounds.append(db)
            nr = -(-db // wf) if db > 0 else 0
            if nr:
                staged.append(fold_corpus(buf, 0, nr, wf, halo))
                owner.append(np.full(nr, b, dtype=np.int64))
                meta.append(
                    np.stack(
                        [np.full(nr, db), np.arange(nr) * wf], axis=1
                    ).astype(np.int32)
                )
        uniq = np.zeros((B, p_pad), dtype=np.int64)
        if staged:
            rows_all = np.concatenate(staged)
            owner_all = np.concatenate(owner)
            meta_all = np.concatenate(meta)
            n_items = rows_all.shape[0]
            # One compiled shape: groups padded to a fixed power-of-two row
            # bucket, dispatched back-to-back and fetched afterwards.
            cap = 8 * (self.config.batch_blocks or 128)
            gmax = max(
                8, min(n_items, cap, self.config.chunk_bytes // (wf + halo))
            )
            gmax = max(8, 1 << (gmax.bit_length() - 1))
            if plan.use_corr:
                from ..ops.corr_engine import _group_rows, scan_corr_batch

                kern_np, thr_np, corr_stride = self._corr_kernel()
                dkern = jax.numpy.asarray(kern_np)
                dthr = jax.numpy.asarray(thr_np)
                dalph = jax.numpy.asarray(self._corr_alphabet())
                g_rows = _group_rows(
                    wf + halo, len(self._corr_alphabet()), gmax
                )
            else:
                dpat = jax.numpy.asarray(self._pat)
            handles = []
            for g0 in range(0, n_items, gmax):
                ng = min(gmax, n_items - g0)
                rows = np.zeros((gmax, wf + halo), dtype=np.uint8)
                rows[:ng] = rows_all[g0 : g0 + ng]
                gmeta = np.zeros((gmax, 2), dtype=np.int32)  # pad: bound 0
                gmeta[:ng] = meta_all[g0 : g0 + ng]
                if plan.use_corr:
                    limits = np.clip(gmeta[:, 0] - gmeta[:, 1], 0, wf)
                    cnts = scan_corr_batch(
                        jax.numpy.asarray(rows), dkern, dthr, dalph,
                        jax.numpy.asarray(limits.astype(np.int32)),
                        wf=wf, fold=1, g_rows=g_rows,
                        stride=corr_stride, p_out=p_pad,
                    )
                else:
                    cnts = dp_scan(
                        jax.numpy.asarray(rows), dpat,
                        jax.numpy.asarray(gmeta),
                        k=self.k, m_max=self.m_max, wf=wf,
                        plens=self._plens_static, dp=plan.dp,
                    )
                handles.append(cnts)
            # One fetch for every group's per-row counts.
            allc = np.asarray(jax.numpy.stack(handles)).reshape(-1, p_pad)
            np.add.at(uniq, owner_all, allc[:n_items])

        for b, buf in enumerate(bufs):
            uniq[b, : self.scan_patterns.num_patterns] += self.tail_counts(
                buf, bounds[b]
            )
        for b in range(B):
            out[b] = uniq[b, : self.scan_patterns.num_patterns][self._inverse]
        return out

    def count(self, corpus: Bytes) -> np.ndarray:
        """Per-pattern match counts (int64, length = number of patterns)."""
        buf = as_u8(corpus)
        n = len(buf)
        p = self.patterns.num_patterns
        t0 = time.perf_counter()
        if n - self.k <= 0:
            self.last_duration = time.perf_counter() - t0
            return np.zeros((p,), dtype=np.int64)

        strategy = self.config.strategy
        n_dev = len(jax.devices())
        if self.config.max_devices is not None:
            n_dev = min(n_dev, self.config.max_devices)
        if strategy == "auto":
            from ..parallel.plan import choose_strategy

            # The corr engine's cost is flat in P, so pattern sharding
            # would replicate the corpus encode per device for nothing.
            # The gate comes from make_plan itself, not a hand-mirrored
            # eligibility test.
            flat_p = False
            if self.k == 0:
                from .pipeline import make_plan

                flat_p = make_plan(self, n).use_corr
            strategy = choose_strategy(
                n,
                self.m_max,
                self.scan_patterns.num_patterns,
                self.k,
                n_dev,
                flat_p_engine=flat_p,
            )

        if strategy == "single" or n_dev == 1:
            counts = self._count_pipeline(buf, n)
        else:
            from ..parallel.strategies import count_distributed

            counts = count_distributed(self, buf, strategy, n_dev)
        uniq = counts[: self.scan_patterns.num_patterns].astype(np.int64)
        expanded = uniq[self._inverse]
        self.last_duration = time.perf_counter() - t0
        self.last_strategy = strategy

        from ..utils.profiling import ScanStats, info

        stats = ScanStats(
            corpus_bytes=n,
            patterns=p,
            unique_patterns=self.scan_patterns.num_patterns,
            k=self.k,
            strategy=strategy,
            backend=self.dp_step().impl,
            block_windows=self.block_windows_for(n),
            seconds=self.last_duration,
        )
        self.meter.record(stats)
        if self.config.verbose:
            info(stats.line())
        return expanded


def scan_counts(
    corpus: Bytes,
    patterns: Sequence[Bytes],
    k: int,
    config: Optional[ApmConfig] = None,
) -> List[int]:
    """One-shot functional API mirroring the reference CLI semantics."""
    return [int(c) for c in Scanner(patterns, k, config).count(corpus)]
