#!/usr/bin/env python
"""Headline benchmark on one accelerator.

Primary metric: steady-state corpus throughput at k = 0 on a 512 MB corpus
(two ``ApmConfig.chunk_bytes`` chunks of one compiled program) with the
reference's own "Big" pattern set (1x 32-char non-existent + 5x 50-char
line_20783) and planted exact occurrences; the single-chunk 256 MB point
rides as the first extra (same compiled program, zero extra compiles).
No figure of this benchmark has been measured on the H100 yet.

``vs_baseline`` compares against the reference's best recorded all-in
throughput on its own headline workload: 1,591,301 bytes in 3.89 s on
3 nodes x (6 ranks x 8 OMP threads) + 1 Pascal GPU per rank
(experiments.xlsx "With GPU" rows 10-12) = ~0.409 MB/s.

Structure: the harness that runs this script reads the LAST JSON line of
stdout, so

  1. The PRIMARY metric runs first, with one fresh compile and an exact
     conformance gate (planted occurrences at k = 0 checked against a
     host substring count), and its JSON line is printed and flushed
     IMMEDIATELY — a later timeout cannot erase it.
  2. Every extra workload is guarded by an internal wall-clock deadline
     (env ``APM_BENCH_DEADLINE_S``, default 900 s): when the budget runs
     low the remaining extras are skipped (recorded in ``skipped``) and
     the final line is emitted early.
  3. Per-phase elapsed is logged to stderr.
  4. The full line (primary + extras) is re-emitted at the end; a
     mid-run kill leaves the primary line as the last JSON on stdout.

Every steady-state metric is min/median/max of >= 5 reps — the headline
``value`` is the MEDIAN with ``*_min``/``*_max`` spread fields — plus a
``session`` tag (UTC timestamp + platform).

Extra metrics (deadline-permitting, highest value first): 256 MB k = 0,
k = 1 / k = 2 steady state with planted matches (conv filtration + device
verification end to end) at 256 and 512 MB, the reference's literal
1.6 MB workload with its byte-contract conformance gate, many-pattern
serving at k = 0 (the correlation engine), the high-k ladder k = 4 /
k = 8 / k = 12, and a 64 MB latency point.
"""

import json
import os
import sys
import time

import numpy as np

REF_BEST_MBPS = 1_591_301 / 3.89 / 1e6  # ~0.409 MB/s
T0 = time.perf_counter()
DEADLINE_S = float(os.environ.get("APM_BENCH_DEADLINE_S", "900"))
# Minimum remaining budget to START an extra workload (an extra started
# with less than this would likely straddle the harness's own timeout).
EXTRA_MARGIN_S = float(os.environ.get("APM_BENCH_EXTRA_MARGIN_S", "120"))
PRIMARY = "steady_state_512mb_6pat_k0"
# Corpus sizes in MB — overridable ONLY for fast smoke runs of the bench
# flow itself (tests / `timeout 300 python bench.py` rehearsals); the
# recorded metrics always use the defaults.
PRIM_MB = int(os.environ.get("APM_BENCH_PRIM_MB", "256"))
LAT_MB = int(os.environ.get("APM_BENCH_LAT_MB", "64"))


def _log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _left() -> float:
    return DEADLINE_S - (time.perf_counter() - T0)


def _emit(payload: dict) -> None:
    print(json.dumps(payload), flush=True)


def _time_stats(fn, reps=5):
    """{"min","med","max"} wall seconds over ``reps`` timed calls."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return {
        "min": ts[0],
        "med": ts[len(ts) // 2] if reps % 2 else (
            ts[reps // 2 - 1] + ts[reps // 2]
        ) / 2,
        "max": ts[-1],
    }


def _metric(extras, name, n_bytes, stats):
    """Record median MB/s + spread for one workload."""
    med = n_bytes / stats["med"] / 1e6
    extras[f"{name}_mb_per_s"] = round(med, 1)
    extras[f"{name}_mb_per_s_min"] = round(n_bytes / stats["max"] / 1e6, 1)
    extras[f"{name}_mb_per_s_max"] = round(n_bytes / stats["min"] / 1e6, 1)
    _log(f"{name}: {extras[f'{name}_mb_per_s']} MB/s "
         f"[{extras[f'{name}_mb_per_s_min']}, "
         f"{extras[f'{name}_mb_per_s_max']}]")
    return med


def _host_exact_count(corpus: bytes, pat: bytes) -> int:
    """Overlapping substring occurrences — the UNTRUNCATED k=0 windows.

    The reference's EOF quirk (``sequential.c:131-134``) truncates the
    last ``m - 1`` windows to the remaining bytes and can still match
    there (the window then only has to equal a PREFIX of the pattern —
    the round-5 512 MB gate caught exactly one such match the plain
    substring count missed), so callers must add the oracle's count
    over the EOF tail separately.
    """
    n, i = 0, corpus.find(pat)
    while i != -1:
        n += 1
        i = corpus.find(pat, i + 1)
    return n


def main() -> int:
    import jax

    from apm.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import apm

    _log(f"jax up, platform={jax.devices()[0].platform}, "
         f"deadline={DEADLINE_S:.0f}s")

    dna = "/root/reference/dna"
    big = os.path.join(dna, "small_chrY_bigger.fa")
    if not os.path.exists(big):
        _emit({
            "metric": PRIMARY, "value": 0.0,
            "unit": "MB/s", "vs_baseline": 0.0, "error": "corpus missing",
        })
        return 1
    ref_corpus = apm.read_input_file(big)
    ref_corpus.setflags(write=False)  # immutable: fingerprint memoized
    pats = [open(os.path.join(dna, "line_non_existent.fa"), "rb").read()] + [
        open(os.path.join(dna, "line_20783.fa"), "rb").read()
    ] * 5

    session = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()) + (
        "/" + jax.devices()[0].platform
    )
    extras = {"session": session}
    skipped = []

    # PRIMARY: 512 MB steady state, k=0, the reference pattern set — with
    # planted exact occurrences so the conformance gate below has real
    # matches to miscount if an engine were broken. Two chunks of one
    # compiled program: one fresh compile.
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT\n", dtype=np.uint8)
    big_mb = 2 * PRIM_MB
    syn = alpha[rng.integers(0, 5, size=big_mb << 20)]
    p1 = np.frombuffer(pats[1], np.uint8)
    # one planted exact copy per MB
    for pos in range(4096, (big_mb - 1) << 20, 1 << 20):
        syn[pos:pos + len(p1)] = p1
    syn.setflags(write=False)
    _log(f"compiling primary ({big_mb} MB, k=0)...")
    sc0 = apm.Scanner(pats, k=0)
    counts0 = sc0.count(syn)  # compile + stage
    _log("primary compiled; conformance gate (host substring count)...")

    # Zero-extra-compile exact conformance gate: overlapping substring
    # count for the untruncated windows + the oracle over the <= m-1
    # EOF-truncated ones (which CAN match at k = 0 under the reference's
    # prefix-truncation quirk — see _host_exact_count).
    syn_b = syn.tobytes()
    m_max = max(len(p) for p in pats)
    tail_expected = apm.utils.oracle.count_matches(
        syn[len(syn) - (m_max - 1) :], pats, 0
    )
    expected0 = [
        _host_exact_count(syn_b, p) + t for p, t in zip(pats, tail_expected)
    ]
    del syn_b
    if counts0.tolist() != expected0:
        _emit({
            "metric": PRIMARY, "value": 0.0, "unit": "MB/s",
            "vs_baseline": 0.0,
            "error": f"{big_mb}MB gate: {counts0.tolist()} != {expected0}",
        })
        return 1
    _log(f"gate ok (counts={counts0.tolist()}); timing primary...")

    mbps = _metric(
        extras, PRIMARY, len(syn), _time_stats(lambda: sc0.count(syn), 5),
    )

    def payload():
        return {
            "metric": PRIMARY,
            "value": round(mbps, 1),
            "unit": "MB/s",
            "vs_baseline": round(mbps / REF_BEST_MBPS, 1),
            "bench_elapsed_s": round(time.perf_counter() - T0, 1),
            **({"skipped": skipped} if skipped else {}),
            **extras,
        }

    # The primary line is now safe on stdout whatever happens next.
    _emit(payload())

    # -- extras, each behind the internal deadline ------------------------
    def budget(name: str) -> bool:
        if _left() < EXTRA_MARGIN_S:
            _log(f"SKIP {name}: {_left():.0f}s left < {EXTRA_MARGIN_S:.0f}s")
            skipped.append(name)
            return False
        _log(f"start {name} ({_left():.0f}s left)")
        return True

    # 256 MB k=0: one chunk of the SAME compiled program as the primary
    # — zero extra compiles, so it runs first among the extras.
    if budget("steady_state_256mb_6pat_k0"):
        try:
            syn256 = syn[: PRIM_MB << 20].copy()
            syn256.setflags(write=False)
            sc256 = apm.Scanner(pats, k=0)
            sc256.count(syn256)
            _metric(
                extras, "steady_state_256mb_6pat_k0", len(syn256),
                _time_stats(lambda: sc256.count(syn256), 5),
            )
            del syn256, sc256
        except Exception as e:
            _log(f"steady_state_256mb_6pat_k0 FAILED: {e!r}")
            extras["steady_state_256mb_6pat_k0_error"] = repr(e)[:200]

    # k=1 / k=2 with REAL matches present: planted fuzzy occurrences
    # exercise conv phase 1 + on-device verification end to end.
    for kk in (1, 2):
        name = f"steady_state_256mb_k{kk}_planted"
        if not budget(name):
            continue
        try:
            from apm.utils.corpus import plant

            syn_k = syn[: PRIM_MB << 20].copy()
            plant(syn_k, p1,
                  list(range(5000, (PRIM_MB - 6) << 20, 1 << 20)),
                  k=kk, seed=7)
            syn_k.setflags(write=False)
            sc_k = apm.Scanner(pats, k=kk)
            sc_k.count(syn_k)
            _metric(
                extras, name, len(syn_k),
                _time_stats(lambda: sc_k.count(syn_k), 5),
            )
            del syn_k, sc_k
        except Exception as e:
            _log(f"{name} FAILED: {e!r}")
            extras[f"{name}_error"] = repr(e)[:200]

    # Large-corpus k=1: same chunk shape (and so the same compiled
    # program) as the 256 MB k=1 extra, but two chunks — the k>=1
    # ceiling once per-call fixed cost is amortized over twice the bytes.
    if budget("steady_state_512mb_k1_planted"):
        try:
            from apm.utils.corpus import plant

            syn512k = alpha[rng.integers(0, 5, size=(2 * PRIM_MB) << 20)]
            plant(syn512k, p1,
                  list(range(5000, ((2 * PRIM_MB) - 6) << 20, 1 << 20)),
                  k=1, seed=11)
            syn512k.setflags(write=False)
            sc512k = apm.Scanner(pats, k=1)
            sc512k.count(syn512k)
            _metric(
                extras, "steady_state_512mb_k1_planted", len(syn512k),
                _time_stats(lambda: sc512k.count(syn512k), 5),
            )
            del syn512k, sc512k
        except Exception as e:
            _log(f"steady_state_512mb_k1_planted FAILED: {e!r}")
            extras["steady_state_512mb_k1_planted_error"] = repr(e)[:200]

    # Reference byte-contract gate + latency line item (1.6 MB shapes:
    # one fresh compile, shared between gate and timing).
    if budget("latency_bound_1p6mb_k0"):
        try:
            sc_small = apm.Scanner(pats, k=0)
            counts = sc_small.count(ref_corpus)
            expected = apm.utils.oracle.count_matches(ref_corpus, pats, 0)
            if counts.tolist() != expected:
                _emit({
                    "metric": PRIMARY, "value": 0.0, "unit": "MB/s",
                    "vs_baseline": 0.0,
                    "error": (
                        f"ref gate: {counts.tolist()} != {expected}"
                    ),
                })
                return 1
            _metric(
                extras, "latency_bound_1p6mb_k0", len(ref_corpus),
                _time_stats(lambda: sc_small.count(ref_corpus), 5),
            )
        except Exception as e:
            _log(f"latency_bound_1p6mb_k0 FAILED: {e!r}")
            extras["latency_bound_1p6mb_k0_error"] = repr(e)[:200]

    # Many-pattern serving: 64 distinct 50-char patterns at k = 0 routes
    # the correlation engine, whose cost is flat in pattern count.
    if budget("steady_state_256mb_64pat_k0"):
        try:
            pats64 = [
                bytes(alpha[rng.integers(0, 4, size=50)]) for _ in range(64)
            ]
            syn256b = syn[: PRIM_MB << 20].copy()
            syn256b.setflags(write=False)
            sc_p64 = apm.Scanner(pats64, 0)
            sc_p64.count(syn256b)
            _metric(
                extras, "steady_state_256mb_64pat_k0", len(syn256b),
                _time_stats(lambda: sc_p64.count(syn256b), 5),
            )
            del syn256b
            del sc_p64
        except Exception as e:
            _log(f"steady_state_256mb_64pat_k0 FAILED: {e!r}")
            extras["steady_state_256mb_64pat_k0_error"] = repr(e)[:200]

    # High-k ladder on a 256 MB corpus with planted k-error occurrences:
    #   k=4,  6x 50-char  -> exact-piece filtration (tier (5, 0));
    #   k=8,  2x 120-char -> banded DP (banded tier: no phase 1);
    #   k=12, 6x 50-char  -> Myers bit-parallel DP (no tier applies).
    def _highk(name, kk, pat_list):
        if not budget(name):
            return
        try:
            from apm.utils.corpus import plant

            syn_k = syn[: PRIM_MB << 20].copy()
            for i, pk in enumerate(pat_list):
                plant(
                    syn_k,
                    np.frombuffer(pk, np.uint8),
                    list(range(
                        5000 + i * 131072, (PRIM_MB - 6) << 20, 1 << 20
                    )),
                    k=kk,
                    seed=13 + i,
                )
            syn_k.setflags(write=False)
            sc_k = apm.Scanner(pat_list, k=kk)
            sc_k.count(syn_k)
            _metric(
                extras, name, len(syn_k),
                _time_stats(lambda: sc_k.count(syn_k), 5),
            )
            del syn_k, sc_k
        except Exception as e:
            _log(f"{name} FAILED: {e!r}")
            extras[f"{name}_error"] = repr(e)[:200]

    pats50 = [bytes(alpha[rng.integers(0, 4, size=50)]) for _ in range(6)]
    pats120 = [bytes(alpha[rng.integers(0, 4, size=120)]) for _ in range(2)]
    _highk("steady_state_256mb_k4_exact_tier", 4, pats50)
    _highk("steady_state_256mb_k8_banded_tier", 8, pats120)
    _highk("steady_state_256mb_k12_myers_dp", 12, pats50)

    # One 64 MB call: a latency point, where per-call fixed cost (host
    # staging, dispatch, fetch) weighs more than at 512 MB.
    if budget("latency_floor_64mb_6pat_k0"):
        try:
            syn64 = syn[: LAT_MB << 20].copy()
            syn64.setflags(write=False)
            sc64 = apm.Scanner(pats, k=0)
            sc64.count(syn64)
            _metric(
                extras, "latency_floor_64mb_6pat_k0", len(syn64),
                _time_stats(lambda: sc64.count(syn64), 5),
            )
            del syn64, sc64
        except Exception as e:
            _log(f"latency_floor_64mb_6pat_k0 FAILED: {e!r}")
            extras["latency_floor_64mb_6pat_k0_error"] = repr(e)[:200]

    _log(f"done; {len(skipped)} extras skipped {skipped or ''}")
    _emit(payload())
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # always emit the one JSON line the driver expects
        _emit({
            "metric": PRIMARY,
            "value": 0.0,
            "unit": "MB/s",
            "vs_baseline": 0.0,
            "error": f"{type(e).__name__}: {e}"[:300],
        })
        sys.exit(1)
