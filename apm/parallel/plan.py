"""Execution planner: what remains of the reference's runtime cost model.

The reference picks between its two MPI strategies with a ratio heuristic
(``getRatio`` at ``src/main.c:21-28``, applied at ``main.c:88-139``; the
derivation lives in ``Workflow.md:100-271``): it measures how well the
pattern count divides over active ranks vs over OMP threads and runs the
strategy that wastes less. Here one jitted program shards the window axis
*and* vectorizes the pattern axis, so most of that decision dissolves, but
two planning decisions remain:

* which axis to shard (windows vs patterns) when devices > 1;
* the staging block width ``w`` (windows per block of ``ROWS_PER_BLOCK``
  staged rows), which sets the row width the kernels tile.

Both are derived here from ``(n, m_max, P, k, n_dev)`` — statically, before
compilation, like the reference's selector (every rank computes the same
deterministic answer, ``main.c:110-114``).
"""

from __future__ import annotations

from dataclasses import dataclass


def get_ratio(x: float) -> float:
    """Literal port of the reference's waste metric (``src/main.c:21-28``).

    Doubles ``x`` until it reaches 1, then reports the overshoot. 0 means the
    division is perfectly balanced; larger means more idle capacity. Kept for
    parity/testing and for the strategy choice below.
    """
    if x <= 0:
        return float("inf")
    while x < 1:
        x *= 2
    return x - 1


# Upper window-count bound for pattern sharding: 4x the largest corpus in
# the measured crossover grid (4 MB; bench/crossover_cpu8.jsonl). Beyond
# it the un-measured corpus-replication transfer cost dominates on real
# multi-chip hardware, so the window axis is sharded instead.
# CPU-mesh-calibrated: see the health warning in choose_strategy.
PATTERNS_NW_MAX = 16 << 20


def choose_strategy(
    n: int,
    m_max: int,
    p: int,
    k: int,
    n_dev: int,
    *,
    flat_p_engine: bool = False,
) -> str:
    """Pick the mesh axis to shard. The reference derived its crossover
    from the ``getRatio`` waste metric (``main.c:88-139``,
    ``Workflow.md:100-271``); this rule is set from a measured grid
    instead (``bench/crossover.py`` → ``bench/crossover_cpu8.jsonl``,
    8-device mesh, session 2026-08-20, corpus 64 KB-4 MB x P 8-128,
    k = 1, 3 reps):

    * ``p == n_dev`` (one pattern per device — zero padding on either
      axis, no halo staging, no psum): patterns-over-devices won at
      EVERY corpus size, 1.22-3.88x (db_t/pat_t; the 3.88 is 64 KB
      where strategy-B per-shard fixed costs dominate).
    * ``p >= 4*n_dev``: statistical tie (0.79-1.14 across the grid) —
      both axes split cleanly; database wins the tie because its halo
      (``n_dev * m_max`` bytes total) is cheaper than replicating the
      corpus to every device, and its shards parallelize the staging.
    * ``p < n_dev``: patterns would idle ``n_dev - p`` devices entirely
      — database sharding uses all of them.

    The rule applies only inside (4x of) the measured corpus range:
    patterns-over-devices replicates the corpus to every device, a cost
    that grows with ``n`` and that the shared-memory CPU mesh
    structurally cannot observe (replication there is free; on real
    multi-chip hardware it is ``n_dev``x the h2d bytes). The measured
    win narrows with size (3.88x at 64 KB -> 1.22x at 4 MB), so beyond
    ``PATTERNS_NW_MAX`` (16 MB of windows = 4x the largest measured
    point) database sharding — which transfers each corpus byte once —
    is the safe default.

    Round 1 asserted ``nw < 4*n_dev*1024 and p >= 8*n_dev`` (tiny
    corpus, many patterns) from the then-slow dynamic-length path; the
    measured grid shows that region is a tie, so the rule collapsed to
    the one measured win.

    **Health warning — CPU-mesh calibration.** The ``p == n_dev`` win
    and ``PATTERNS_NW_MAX`` were measured on an 8-device *virtual CPU
    mesh*, where "replicating the corpus to every device" is a no-op
    (shared host memory). On real multi-chip hardware that replication
    is ``n_dev``x the h2d bytes plus ``n_dev``x the per-device encode —
    a cost this calibration structurally cannot see, so the crossover
    may flip well below ``PATTERNS_NW_MAX``. Treat the rule as a
    CPU-mesh artifact: re-measure the ``bench/crossover.py`` grid on
    silicon before trusting it for multi-chip deployment (DESIGN §3).

    ``flat_p_engine=True`` pins database: the k = 0 correlation engine's
    cost is flat in P (extra patterns are extra output channels of one
    conv), so replicating the corpus encode per device is pure loss.
    """
    if n_dev <= 1:
        return "single"
    nw = max(n - k, 0)
    if nw < n_dev:  # degenerate: fewer windows than devices
        return "single"
    if not flat_p_engine and p == n_dev and nw <= PATTERNS_NW_MAX:
        return "patterns_over_devices"
    return "database_over_devices"


# Staged rows per block: a block of ``w`` windows is ``ROWS_PER_BLOCK``
# rows of ``wf = w // ROWS_PER_BLOCK`` windows.
ROWS_PER_BLOCK = 8

# Block-width bounds (windows). The top keeps staging rows at 8192
# windows — a power of two the DP kernel's tiles divide, and short enough
# that phase-2 verification of a hot row stays cheap.
BLOCK_MIN = 1024
BLOCK_MAX = 65536


def choose_block_windows(nw: int, m_max: int, p: int, k: int) -> int:
    """Staging block width: a power of two in ``[BLOCK_MIN, BLOCK_MAX]``.

    Small corpora get the smallest power of two covering them (less
    padding); everything else gets ``BLOCK_MAX``. The DP kernel's window
    tile (``apm.ops.pallas_kernel.pick_tile``) divides every width this
    returns, and its registers hold one pattern's band at a time, so the
    width no longer depends on ``p`` or ``k`` (kept in the signature for
    the planner's callers).
    """
    del m_max, p, k
    w = BLOCK_MIN
    while w < min(max(nw, 1), BLOCK_MAX):
        w *= 2
    return w


@dataclass(frozen=True)
class Plan:
    strategy: str
    block_windows: int
    n_dev: int

    @staticmethod
    def make(n: int, m_max: int, p: int, k: int, n_dev: int) -> "Plan":
        strategy = choose_strategy(n, m_max, p, k, n_dev)
        w = choose_block_windows(max(n - k, 0), m_max, p, k)
        return Plan(strategy=strategy, block_windows=w, n_dev=n_dev)
