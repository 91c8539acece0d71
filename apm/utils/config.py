"""Configuration for the scan pipeline.

Replaces the reference's three config tiers (compile-time ``-D`` flags,
``OMP_NUM_THREADS``, CLI positionals + trailing strategy word — SURVEY.md §5)
with one dataclass.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ApmConfig:
    # How the banded DP step runs: "auto" (the Pallas/Triton kernel on a
    # GPU, the plain XLA band on the CPU), "pallas" (the kernel; needs a
    # GPU or interpret=True), or "xla" (the plain XLA band anywhere — the
    # reference the kernel is timed against). Decided in one place,
    # apm.ops.pallas_kernel.resolve_impl; nothing else depends on it.
    backend: str = "auto"
    # Run the Pallas kernel in the Pallas interpreter (CPU testing; never
    # chosen implicitly).
    interpret: bool = False
    # Windows per staging block (ROWS_PER_BLOCK rows). None = let the
    # planner pick (apm.parallel.plan.choose_block_windows).
    block_windows: Optional[int] = None
    # Corpus bytes handed to one jitted chunk invocation (host-side loop
    # unit; bounds host staging + device transfer per call and keeps every
    # chunk the same compiled shape).
    chunk_bytes: int = 256 << 20
    # Distribution strategy across devices: "auto", "database_over_devices"
    # (shard the window axis, halo + psum — reference strategy B),
    # "patterns_over_devices" (shard the pattern axis — reference strategy A),
    # or "single" (no sharding).
    strategy: str = "auto"
    # Emit per-phase timing info (reference APM_INFO analog).
    verbose: bool = False
    # Optional cap on devices used (None = all visible).
    max_devices: Optional[int] = None
    # Scan each distinct pattern once and expand counts to duplicates.
    dedup_patterns: bool = True
    # Scan engine: "auto" routes by input (k = 0 correlation when eligible,
    # k >= 1 pigeonhole filtration for the patterns its piece correlation
    # takes, the banded DP for the rest — apm.models.pipeline.make_plan);
    # "dp" forces the banded DP everywhere; "corr" forces the k = 0
    # correlation engine (apm.ops.corr_engine) and raises when the scan is
    # ineligible for it.
    engine: str = "auto"
    # Banded-DP implementation: "auto" picks the bit-parallel (Myers/Hyyro)
    # band once it beats the classic diagonal band (measured crossover,
    # apm.ops.pallas_kernel.MYERS_KMIN_AUTO); "band" forces the classic
    # per-diagonal min-chains; "myers" forces the bit-parallel band
    # wherever it is representable (1 <= k <= 14, alphabet <= 8 distinct
    # bytes). The plain XLA band has no bit-parallel mode.
    dp_impl: str = "auto"
    # Keep the staged corpus device-resident between count() calls (keyed by
    # a full-content hash) so repeated scans skip host->device transfer.
    # Buffers frozen with setflags(write=False) additionally memoize their
    # hash by identity; freezing is a promise the content is final —
    # thawing a scanned frozen buffer, mutating it in place, and
    # re-freezing it is unsupported (pass a fresh array, or keep the
    # buffer writable to be re-hashed every call).
    cache_corpus: bool = True
    # Byte budget for the device-resident corpus cache. None = a quarter of
    # the device's reported HBM (fallback 4 GiB when unknown).
    cache_bytes: Optional[int] = None
    # Pre-compile the scan programs for this corpus size on a background
    # daemon thread at Scanner construction (service startup absorbs the
    # first compile while the host finishes loading). None = no prewarm. Join with Scanner.prewarm_join(); a count() that
    # arrives first simply shares the compile (XLA compiles are
    # thread-safe and deduplicated).
    prewarm_bytes: Optional[int] = None
    # Blocks (of ROWS_PER_BLOCK rows) per count_batch device call (group
    # bucket). None = 128: groups dispatch back-to-back so staging and
    # transfer of group g+1 overlap the device work on group g. Lower for
    # small batches to cut padding.
    batch_blocks: Optional[int] = None

    def validate(self) -> "ApmConfig":
        if self.backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.strategy not in (
            "auto",
            "single",
            "database_over_devices",
            "patterns_over_devices",
        ):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.engine not in ("auto", "dp", "corr"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.dp_impl not in ("auto", "band", "myers"):
            raise ValueError(f"unknown dp_impl {self.dp_impl!r}")
        if self.cache_bytes is not None and self.cache_bytes < 0:
            raise ValueError("cache_bytes must be >= 0")
        if self.batch_blocks is not None and self.batch_blocks <= 0:
            raise ValueError("batch_blocks must be > 0")
        if self.prewarm_bytes is not None and self.prewarm_bytes < 0:
            raise ValueError("prewarm_bytes must be >= 0")
        if self.block_windows is not None and (
            self.block_windows % 128 != 0 or self.block_windows <= 0
        ):
            raise ValueError("block_windows must be a positive multiple of 128")
        return self
