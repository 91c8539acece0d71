#!/usr/bin/env python
"""Measure the patterns- vs database-over-devices crossover.

The planner's auto rule (`apm/parallel/plan.py choose_strategy`) decides
between reference strategy A (shard the pattern axis, corpus replicated)
and strategy B (shard the window axis, halo + psum). The reference
DERIVED its crossover from a cost ratio (`Workflow.md:100-271`,
`main.c:88-139` get_ratio); round 1 ASSERTED one (`nw < 4*n_dev*1024 and
p >= 8*n_dev`) from the then-slow dynamic-length path and never
re-measured. This sweep measures both strategies across a (corpus bytes,
pattern count) grid on the 8-device virtual CPU mesh — the same mesh the
tests run on — and prints the measured win/loss matrix plus the implied
gate.

What transfers to real multi-chip hardware and what doesn't: the
grid's *relative* strategy ranking is driven by per-strategy overheads
that exist identically on any mesh (strategy B pays halo bytes + a psum
per scan and its shard must be >= one block; strategy A pays corpus
replication to every device and pattern-group padding). Absolute MB/s on
the shared-core CPU mesh means nothing; the crossover REGION (tiny
corpus x many patterns) is the measurement.

Run:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python bench/crossover.py --out bench/crossover_cpu8.jsonl
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _stats(fn, reps):
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    import jax

    plat = os.environ.get("JAX_PLATFORMS")
    if plat and "," not in plat:
        jax.config.update("jax_platforms", plat)
    jax.config.update(
        "jax_compilation_cache_dir",
        os.environ.get("APM_COMPILE_CACHE", "/root/repo/.jax_cache"),
    )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

    import numpy as np

    import apm
    from apm.utils.config import ApmConfig

    n_dev = len(jax.devices())
    session = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"ACGT\n", dtype=np.uint8)

    if args.quick:
        sizes = [64 << 10, 256 << 10]
        pcounts = [8, 64]
    else:
        sizes = [64 << 10, 256 << 10, 1 << 20, 4 << 20]
        pcounts = [8, 32, 64, 128]

    out_f = open(args.out, "w") if args.out else None
    grid = {}
    for size in sizes:
        corpus = alpha[rng.integers(0, 5, size=size)]
        corpus.setflags(write=False)
        for P in pcounts:
            if size * P > (4 << 20) * 40:
                continue  # keep the largest corner affordable
            pats = [alpha[rng.integers(0, 4, size=50)] for _ in range(P)]
            times = {}
            for strategy in (
                "database_over_devices", "patterns_over_devices"
            ):
                cfg = ApmConfig(strategy=strategy, backend="xla")
                sc = apm.Scanner(pats, 1, cfg)
                sc.count(corpus)  # compile + warm
                st = _stats(lambda: sc.count(corpus), args.reps)
                times[strategy] = st
                rec = {
                    "mode": "crossover",
                    "strategy": strategy,
                    "devices": n_dev,
                    "bytes": size,
                    "patterns": P,
                    "k": 1,
                    "platform": jax.devices()[0].platform,
                    "session": session,
                    "seconds": round(st["med"], 5),
                    "seconds_min": round(st["min"], 5),
                    "seconds_max": round(st["max"], 5),
                    "mb_per_s": round(size / st["med"] / 1e6, 3),
                }
                print(json.dumps(rec), flush=True)
                if out_f:
                    out_f.write(json.dumps(rec) + "\n")
                    out_f.flush()
            ratio = (
                times["database_over_devices"]["med"]
                / times["patterns_over_devices"]["med"]
            )
            grid[(size, P)] = ratio

    print("\npatterns-over-devices advantage (db_t / pat_t; > 1 = patterns wins)")
    print("| bytes \\ P | " + " | ".join(str(p) for p in pcounts) + " |")
    for size in sizes:
        # "-" placeholder for corners skipped by the affordability cap so
        # every ratio prints under its own P column header.
        row = [
            f"{grid[(size, p)]:.2f}" if (size, p) in grid else "-"
            for p in pcounts
        ]
        print(f"| {size >> 10} KB | " + " | ".join(row) + " |")
    wins = [k for k, v in grid.items() if v > 1.05]
    print("\npatterns wins at:", sorted(wins) or "nowhere")
    if out_f:
        out_f.write(json.dumps({"mode": "crossover_summary", "session": session,
                                "ratios": {f"{s}:{p}": round(v, 3)
                                           for (s, p), v in grid.items()}}) + "\n")
        out_f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
