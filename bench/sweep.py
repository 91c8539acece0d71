#!/usr/bin/env python
"""Parameterized benchmark sweep — the analog of the reference's 104 SLURM
batch scripts (``scripts/{medium,big,gpu}/N*_n*_omp*.batch``), collapsed
into one parameterized driver.

Each point measures warm end-to-end Scanner throughput for a
(corpus, #patterns, k, strategy) combination and emits one JSON line
carrying min/median/max over the reps; a summary table prints at the end.

Usage::

    python bench/sweep.py                  # default grid on the real device
    python bench/sweep.py --quick          # tiny grid (CI smoke)
    python bench/sweep.py --scaling        # device-count x strategy sweep
    JAX_PLATFORMS=cpu python bench/sweep.py --quick   # portable
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _stats(fn, reps):
    """{"min","med","max"} wall seconds over ``reps`` timed calls."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    med = ts[len(ts) // 2] if reps % 2 else (
        ts[reps // 2 - 1] + ts[reps // 2]
    ) / 2
    return {"min": ts[0], "med": med, "max": ts[-1]}


def _sess():
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def run_scaling(args, jax, np, apm, ApmConfig) -> int:
    """Scaling-efficiency sweep: bytes/s vs device count per strategy.

    The analog of the reference's entire ``scripts/{medium,big}/**`` ranks x
    threads suite (104 SLURM scripts) whose output is BASELINE.md's
    "scaling shape" row. On the virtual CPU mesh the devices share the same
    physical cores, so wall-clock cannot *improve* with n_dev beyond the
    core count — what this measures there is the *partitioning overhead
    shape* (halo staging, psum, shard assembly): efficiency(n) = T(1) /
    T(n), ideal = 1.0 on saturated cores. On real multi-chip hardware the
    same sweep measures true scaling (per-device throughput rising toward
    n x single-chip).

    A ``scaling_interpret`` configuration additionally runs the REAL
    Pallas kernel (interpret mode) under the same 8-device shard_map —
    covering the sharded kernel dispatch path the XLA points cannot.
    """
    backend = "auto"
    n_avail = len(jax.devices())
    devices = [d for d in (1, 2, 4, 8) if d <= n_avail]
    size = (1 << 20) if args.quick else (args.size_mb << 20)
    rng = np.random.default_rng(1)
    alpha = np.frombuffer(b"ACGT\n", dtype=np.uint8)
    corpus = alpha[rng.integers(0, 5, size=size)]
    pats = [alpha[rng.integers(0, 5, size=50)] for _ in range(16)]
    session = _sess()

    out_f = open(args.out, "w") if args.out else None
    results = []

    def run_points(mode, cfg_extra, corpus, tag):
        base_t = None
        for strategy in (
            "database_over_devices", "patterns_over_devices"
        ):
            for n_dev in devices:
                if n_dev == 1 and strategy == "patterns_over_devices":
                    continue  # same single-device point; don't re-time
                cfg = ApmConfig(
                    strategy="single" if n_dev == 1 else strategy,
                    max_devices=n_dev,
                    **cfg_extra,
                )
                sc = apm.Scanner(pats, 1, cfg)
                sc.count(corpus)  # compile + warm
                st = _stats(lambda: sc.count(corpus), args.reps)
                if n_dev == 1:
                    base_t = st["med"]
                rec = {
                    "mode": mode,
                    "strategy": strategy if n_dev > 1 else "single",
                    "devices": n_dev,
                    "bytes": len(corpus),
                    "patterns": len(pats),
                    "k": 1,
                    "backend": cfg_extra.get("backend", backend),
                    "platform": jax.devices()[0].platform,
                    "session": session,
                    "seconds": round(st["med"], 5),
                    "seconds_min": round(st["min"], 5),
                    "seconds_max": round(st["max"], 5),
                    "mb_per_s": round(len(corpus) / st["med"] / 1e6, 2),
                    "efficiency_vs_1dev": round(base_t / st["med"], 3),
                }
                results.append(rec)
                line = json.dumps(rec)
                print(line, flush=True)
                if out_f:
                    out_f.write(line + "\n")
                    out_f.flush()

    run_points("scaling", {"backend": backend}, corpus, "xla")
    if jax.devices()[0].platform == "cpu" and not args.no_interpret:
        # Sharded-kernel coverage: the real kernel in interpret mode is
        # far slower than compiled XLA, so this point uses a small
        # corpus — it validates the sharded dispatch path and measures
        # its overhead shape, not absolute throughput.
        small = corpus[: 1 << 20]
        run_points(
            "scaling_interpret",
            {"backend": "pallas", "interpret": True},
            small,
            "pallas-interpret",
        )
    if out_f:
        out_f.close()
    print("\n| mode | strategy | devices | MB/s | efficiency |")
    print("|---|---|---|---|---|")
    for r in results:
        print(
            f"| {r['mode']} | {r['strategy']} | {r['devices']} "
            f"| {r['mb_per_s']} | {r['efficiency_vs_1dev']} |"
        )
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="tiny grid")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help="write JSONL to this path")
    ap.add_argument(
        "--scaling",
        action="store_true",
        help="device-count x strategy scaling sweep instead of the "
        "corpus x P x k grid",
    )
    ap.add_argument(
        "--size-mb",
        type=int,
        default=32,
        help="scaling-sweep corpus MB (default 32; ignored with --quick)",
    )
    ap.add_argument(
        "--no-interpret",
        action="store_true",
        help="skip the pallas-interpret scaling configuration",
    )
    args = ap.parse_args()

    import jax

    from apm.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np

    import apm
    from apm.utils.config import ApmConfig
    from apm.utils.oracle import count_matches

    if args.scaling:
        return run_scaling(args, jax, np, apm, ApmConfig)

    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT\n", dtype=np.uint8)

    corpora = {}
    if not args.quick:
        corpora["synth64M"] = alpha[rng.integers(0, 5, size=64 << 20)]
    else:
        corpora = {"synth1M": alpha[rng.integers(0, 5, size=1 << 20)]}

    def mk_patterns(count):
        return [alpha[rng.integers(0, 5, size=50)] for _ in range(count)]

    grid_pat = [1, 8] if args.quick else [1, 6, 8]
    grid_k = [0, 1] if args.quick else [0, 1, 4]
    backend = "auto"
    session = _sess()

    results = []
    out_f = open(args.out, "w") if args.out else None
    for cname, corpus in corpora.items():
        for np_ in grid_pat:
            pats = mk_patterns(np_)
            for k in grid_k:
                cfg = ApmConfig(backend=backend)
                sc = apm.Scanner(pats, k, cfg)
                counts = sc.count(corpus)  # compile + warm cache
                if len(corpus) <= (512 << 10):  # oracle check: small only
                    assert counts.tolist() == count_matches(corpus, pats, k)
                st = _stats(lambda: sc.count(corpus), args.reps)
                rec = {
                    "corpus": cname,
                    "bytes": len(corpus),
                    "patterns": np_,
                    "k": k,
                    "backend": backend,
                    "session": session,
                    "seconds": round(st["med"], 5),
                    "seconds_min": round(st["min"], 5),
                    "seconds_max": round(st["max"], 5),
                    "mb_per_s": round(len(corpus) / st["med"] / 1e6, 2),
                }
                results.append(rec)
                line = json.dumps(rec)
                print(line, flush=True)
                if out_f:
                    out_f.write(line + "\n")
                    out_f.flush()
    if out_f:
        out_f.close()

    print("\n| corpus | bytes | P | k | MB/s |")
    print("|---|---|---|---|---|")
    for r in results:
        print(
            f"| {r['corpus']} | {r['bytes']} | {r['patterns']} | {r['k']} "
            f"| {r['mb_per_s']} |"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
