"""Pigeonhole filtration: which patterns a piece scan can take (pure Python).

The filtration theorem (Navarro's taxonomy; used by nrgrep/agrep): split a
pattern of length ``m`` into ``j`` contiguous pieces — any equal-length
window within edit distance ``k`` induces a partition of the window into
``j`` aligned substrings whose edit distances sum to <= ``k``, so some
piece matches its aligned substring with at most ``floor(k / j)`` errors.
Two tiers instantiate this:

* **exact tier** (``j = k + 1`` pieces, 0 errors each);
* **banded tier** (``j = k//2 + 1`` pieces, 1 error each) — covers
  mid-length patterns at k >= 5 whose ``k+1``-way split would make pieces
  too short to be selective.

Phase 1 of the scan runs the exact tier as a correlation
(``apm.ops.corr_engine.scan_pieces_conv``), which needs error-free pieces
of at least :data:`FP1_LMIN` bytes; phase 2 (``apm.ops.fused``) verifies
the candidate rows with the banded DP. Patterns phase 1 cannot take run
the banded DP over the whole corpus. The banded tier has no phase-1
implementation: a correlation cannot express a one-error piece.

The reference has no analog of this; its kernels always run the full
O(m^2) DP per window (``src/utils.c:76-99``).
"""

from __future__ import annotations

K_MAX = 16  # filtration eligibility cap (both tiers)

# Minimum piece length per tier: the phase-1 cost is ~independent of k
# (each pattern char is processed once), so what bounds eligibility is
# *selectivity* — a staging row (wf ~ 8k windows) must stay cold for
# targeted verification to pay. On 4-letter text an exact piece of length
# l fires per start with prob 4^-l; a kp=1 banded piece with prob
# ~8l / 4^l. l >= 14 keeps kp=1 rows cold through k = 8; k in [9, 16]
# needs l >= 16. The density fallback protects pathological corpora.
EXACT_LMIN_HIGH = 14  # exact tier, k >= 5
BANDED_LMIN = {5: 14, 6: 14, 7: 14, 8: 14}  # else 16 for k in [9, 16]

# Minimum piece length for the correlation phase 1. Row-any candidacy
# (a row is hot if any piece hits anywhere in it) pays a selectivity
# penalty against a per-window shift test; at the exact-tier edge (l = 8,
# 4^-8 background) that floods every row, so pieces carry a couple more
# bytes of selectivity.
FP1_LMIN = 10


def pieces_of_j(m: int, j: int):
    """Static piece table: [(offset, length)] — j contiguous pieces."""
    l = m // j
    return [(i * l, l if i < j - 1 else m - (j - 1) * l) for i in range(j)]


def pieces_of(m: int, k: int):
    """Exact-tier piece table (k + 1 pieces)."""
    return pieces_of_j(m, k + 1)


def banded_j(k: int) -> int:
    """Piece count of the banded tier: the fewest pieces with k//j == 1
    (fewest = longest pieces = most selective)."""
    return k // 2 + 1


def tier_of(m: int, k: int):
    """Filtration tier for one pattern: ``(j, kp)`` or None.

    Exact pieces are preferred (cheaper and more selective); the banded
    tier extends coverage to mid-length patterns at k in [5, 16].
    """
    if m < 1:
        return None
    if k == 0:
        return (1, 0)
    if k <= 4:
        return (k + 1, 0) if m // (k + 1) >= max(k, 8) else None
    if k <= K_MAX:
        if m // (k + 1) >= EXACT_LMIN_HIGH:
            return (k + 1, 0)
        j = banded_j(k)
        if m // j >= BANDED_LMIN.get(k, 16):
            return (j, 1)
    return None


def filter_eligible(m: int, k: int) -> bool:
    """True when the correlation phase 1 can take an (m, k) pattern:
    k >= 1, exact tier, every piece at least :data:`FP1_LMIN` bytes and
    at most the correlation's kernel width."""
    from .corr_engine import M_MAX_CORR

    if k < 1:
        return False
    tier = tier_of(m, k)
    if tier is None or tier[1] != 0:
        return False
    lengths = [length for _, length in pieces_of_j(m, tier[0])]
    return min(lengths) >= FP1_LMIN and max(lengths) <= M_MAX_CORR


def partition_plens(plens: tuple, k: int, engine: str, alphabet_size: int):
    """Split a static length tuple into ``(fmask, filtered, banded-DP)``.

    Filtration takes the eligible patterns when ``engine == "auto"``, the
    pattern alphabet fits the correlation's channels, and the filtered set
    is heavy or long enough for the correlation to lead the banded DP
    (``corr_engine.AUTO_MIN_WORK`` / ``AUTO_MIN_MMAX``); otherwise every
    pattern runs the banded DP.
    """
    from .corr_engine import ALPHABET_MAX, AUTO_MIN_MMAX, AUTO_MIN_WORK

    use = engine == "auto" and 0 < alphabet_size <= ALPHABET_MAX
    fmask = tuple(use and m > 0 and filter_eligible(m, k) for m in plens)
    ms = [m for m, f in zip(plens, fmask) if f]
    if ms and not (sum(ms) >= AUTO_MIN_WORK or max(ms) >= AUTO_MIN_MMAX):
        fmask = tuple(False for _ in plens)
    plens_filter = tuple(m if f else 0 for m, f in zip(plens, fmask))
    plens_dp = tuple(0 if f else m for m, f in zip(plens, fmask))
    return fmask, plens_filter, plens_dp
