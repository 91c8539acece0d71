"""Tracing, profiling, and throughput metering.

The reference's observability is wall-clock brackets (``gettimeofday`` at
``sequential.c:102,147``, ``MPI_Wtime`` at ``patterns_over_ranks.c:135,222``)
plus compile-time ``printf`` gates (``APM_INFO``/``APM_DEBUG``,
``patterns_over_ranks.c:27-31``). The equivalents here:

* :func:`trace` — context manager around ``jax.profiler`` producing a full
  host + device trace viewable in TensorBoard/Perfetto (replaces external kernel
  timing, SURVEY.md §5 "Tracing / profiling");
* :class:`ScanStats` / :class:`Meter` — bytes/s throughput accounting, the
  north-star metric (corpus GB/s/chip, BASELINE.md);
* :func:`info` — the ``APM_INFO`` analog, gated by config/env instead of a
  compile-time ``-D`` flag.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional


def info(msg: str, *, enabled: bool = True) -> None:
    """APM_INFO analog: runtime-gated progress line on stderr."""
    if enabled or os.environ.get("APM_INFO"):
        print(f"[apm] {msg}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/apm_trace") -> Iterator[str]:
    """Capture a jax.profiler device trace around a scan.

    Usage::

        with profiling.trace("/tmp/apm_trace"):
            scanner.count(corpus)

    View with TensorBoard's profile plugin or Perfetto.
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@dataclass
class ScanStats:
    """One scan's throughput record."""

    corpus_bytes: int
    patterns: int
    unique_patterns: int
    k: int
    strategy: str
    backend: str
    block_windows: int
    seconds: float

    @property
    def mb_per_s(self) -> float:
        return self.corpus_bytes / max(self.seconds, 1e-12) / 1e6

    @property
    def gb_per_s(self) -> float:
        return self.mb_per_s / 1e3

    @property
    def cells_per_s(self) -> float:
        """DP lattice throughput: windows x patterns x pattern-length / s."""
        return (
            self.corpus_bytes
            * self.unique_patterns
            / max(self.seconds, 1e-12)
        )

    def line(self) -> str:
        return (
            f"{self.corpus_bytes} B x {self.patterns} pat "
            f"({self.unique_patterns} uniq) k={self.k} "
            f"[{self.strategy}/{self.backend} w={self.block_windows}] "
            f"in {self.seconds:.4f} s -> {self.mb_per_s:.1f} MB/s"
        )


@dataclass
class Meter:
    """Accumulates ScanStats across scans (serving-style aggregate view)."""

    history: List[ScanStats] = field(default_factory=list)

    def record(self, stats: ScanStats) -> None:
        self.history.append(stats)

    @property
    def total_bytes(self) -> int:
        return sum(s.corpus_bytes for s in self.history)

    @property
    def total_seconds(self) -> float:
        return sum(s.seconds for s in self.history)

    @property
    def aggregate_mb_per_s(self) -> float:
        return self.total_bytes / max(self.total_seconds, 1e-12) / 1e6


class Stopwatch:
    """Minimal phase timer (the gettimeofday-bracket analog)."""

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.laps: List[tuple] = []

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.laps.append((name, dt))
        self.t0 = now
        return dt
