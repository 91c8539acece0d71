#!/usr/bin/env python
"""Smoke test of apm's device pipeline on one NVIDIA GPU, in one process.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the sharded strategies only

Phases (one GPU): 1. device check; 2. compile every DP kernel variant and
the correlation programs at real widths, with their memory analysis;
3. zero-tolerance conformance of the Triton DP kernel (both modes, all
three epilogues), the correlation and the piece correlation against the
plain XLA band and the NumPy oracle; 4. the main path on a 512 MB
reference-shaped corpus through ``Scanner.count`` and the CLI at k = 0, 1,
2; 5. ``count_batch`` and ``find``; 6. end-to-end A/B of the DP kernel
against the plain XLA band through ``Scanner.count``.

``--four`` runs only the 1 GiB sharded scan (``database_over_devices`` and
``patterns_over_devices``) and its one-card comparison.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``. Any failure —
including no GPU, or a checkout without the ``apm`` package — exits
non-zero and prints no such line.
"""

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

T0 = time.perf_counter()
WF = 8192  # staging-row width of every corpus of 64 KB and more
SEED = 20783
CONF_BYTES = 16 << 20  # phase 3 corpus
CONF_KS = (0, 1, 2, 3, 4, 8, 12, 14)
CONF_PS = (1, 6, 64)
MAIN_BYTES = 512 << 20  # phases 4-6 corpus
AB_BYTES = 64 << 20  # DP-only A/B cells
FOUR_BYTES = 1 << 30  # --four corpus


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.1f}s] {msg}", flush=True)


def nvidia_smi() -> str:
    """Card name and power limit, read without touching JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return " | ".join(line.strip() for line in out.splitlines())


def timed(fn, reps=3):
    """Median wall seconds of ``reps`` calls after one warm call."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


# -- phase 1 -------------------------------------------------------------


def device_check(n_want: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {devs[0].platform!r}")
    if len(devs) < n_want:
        raise SystemExit(f"need {n_want} GPUs, JAX sees {len(devs)}")
    from apm.utils import native
    from apm.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    smi = nvidia_smi()
    log(
        f"device kind={devs[0].device_kind} count={len(devs)} "
        f"nvidia-smi=[{smi}] native={native.available()} cache={cache}"
    )
    return devs, smi


# -- shared data ---------------------------------------------------------


def pattern_table(pats, k):
    """(k-padded table padded to 8 rows, static lengths) like Scanner's."""
    from apm.ops.common import round_up
    from apm.utils.io import PatternSet

    ps = PatternSet.from_patterns(pats)
    pat, plen = ps.packed(k)
    p_pad = max(8, round_up(len(pats), 8))
    table = np.zeros((p_pad, pat.shape[1]), np.uint8)
    table[: len(pats)] = pat
    plens = tuple(int(x) for x in plen) + (0,) * (p_pad - len(pats))
    return table, plens, ps.max_len


def oracle_rows(corpus, pats, k, rows):
    """Oracle counts ``(len(rows), P)`` of untruncated windows per row."""
    from apm.utils import native
    from apm.utils.oracle import banded_distances

    out = np.zeros((len(rows), len(pats)), np.int64)
    for ri, r in enumerate(rows):
        for pi, p in enumerate(pats):
            pa = np.frombuffer(p, np.uint8)
            seg = corpus[r * WF : r * WF + WF + len(pa) - 1 + k]
            if native.available():
                out[ri, pi] = native.banded_count(seg, pa, k, WF, -1)
            else:
                out[ri, pi] = int(np.sum(banded_distances(seg, pa, k)[:WF] <= k))
    return out


# -- phase 2 -------------------------------------------------------------


def compile_phase():
    """Compile every DP kernel variant and the XLA programs around it at
    the widths ``Scanner.count`` uses on a 512 MB corpus (256 MB chunks of
    8192-window rows), and print each one's memory analysis."""
    import jax
    import jax.numpy as jnp

    from apm.ops.corr_engine import _group_rows, scan_corr_conv, scan_pieces_conv
    from apm.ops.pallas_kernel import DPStep, dp_scan

    rows_chunk = (256 << 20) // WF
    u8, i32 = jnp.uint8, jnp.int32
    sds = jax.ShapeDtypeStruct
    plens = (32, 50) + (0,) * 6
    alph = (10, 65, 67, 71, 84)
    progs = []
    for name, k, dp, mask, n_rows in (
        ("dp band counts", 2, DPStep("pallas"), False, rows_chunk),
        ("dp myers counts", 8, DPStep("pallas", False, alph), False, rows_chunk),
        ("dp band mask", 2, DPStep("pallas"), True, 256),
        ("dp myers mask", 8, DPStep("pallas", False, alph), True, 256),
    ):
        halo = 128 if k == 2 else 256
        progs.append((name, dp_scan.lower(
            sds((n_rows, WF + halo), u8), sds((8, 50 + 2 * k), u8),
            sds((n_rows, 2), i32),
            k=k, m_max=50, wf=WF, plens=plens, dp=dp, mask=mask,
        )))
    g = _group_rows(WF + 128, 5, rows_chunk)
    progs.append(("corr conv k=0", scan_corr_conv.lower(
        sds((rows_chunk, WF + 128), u8), sds((65, 3, 32), jnp.bfloat16),
        sds((32,), jnp.float32), sds((5,), u8), sds((), i32), sds((), i32),
        wf=WF, m_max=50, n_rows=rows_chunk, g_rows=g, stride=16,
    )))
    progs.append(("piece conv k=2", scan_pieces_conv.lower(
        sds((rows_chunk, WF + 128), u8), sds((24, 3, 48), jnp.bfloat16),
        sds((48,), jnp.float32), sds((6, 8), jnp.float32), sds((5,), u8),
        sds((), i32), sds((), i32),
        wf=WF, w_kern=24, n_rows=rows_chunk, g_rows=g, stride=8,
    )))
    for name, lowered in progs:
        t0 = time.perf_counter()
        ma = lowered.compile().memory_analysis()
        log(
            f"compiled {name} in {time.perf_counter() - t0:.1f}s: "
            f"args={ma.argument_size_in_bytes} out={ma.output_size_in_bytes} "
            f"temp={ma.temp_size_in_bytes} code={ma.generated_code_size_in_bytes}"
        )


# -- phase 3 -------------------------------------------------------------


def conformance_phase():
    """Zero-tolerance conformance at real widths on a seeded 16 MB corpus:
    k in {0,1,2,3,4,8,12,14} x P in {1,6,64}, pattern lengths cycling
    through {10,32,50,120}. Counts are integers, so every comparison is
    exact."""
    import jax
    import jax.numpy as jnp

    from apm.ops.common import fold_corpus, round_up
    from apm.ops.corr_engine import (
        _group_rows, build_alphabet, build_kernel, build_piece_kernel,
        pick_stride, scan_corr_conv, scan_pieces_conv,
    )
    from apm.ops.filtration import filter_eligible, tier_of
    from apm.ops.pallas_kernel import DPStep, _myers_mode, dp_scan, row_meta
    from apm.utils.corpus import reference_shaped

    n = CONF_BYTES
    corpus = reference_shaped(n, seed=SEED, exact=0)[0]
    rng = np.random.default_rng(SEED)
    staged = {}
    r_all = n // WF
    n_xla_rows, n_mask_rows = min(64, r_all // 2), min(256, r_all // 2)
    oracle_row_ids = (0, 1, r_all // 2, (3 * r_all) // 4)
    lengths = (10, 32, 50, 120)
    checks = 0
    for ki, k in enumerate(CONF_KS):
        for P in CONF_PS:
            pats = []
            for i in range(P):
                m = lengths[(i + ki) % 4]
                pos = int(rng.integers(0, n - m))
                p = corpus[pos : pos + m].copy()
                n_sub = min(m, int(rng.integers(0, k + 1)))
                for j in rng.choice(m, size=n_sub, replace=False):
                    p[j] = b"ACGT"[int(rng.integers(0, 4))]
                pats.append(bytes(p))
            table, plens, m_max = pattern_table(pats, k)
            halo = round_up(m_max + 2 * k, 128)
            bound = n - m_max + 1
            n_rows = -(-bound // WF)
            if (halo, n_rows) not in staged:
                staged[(halo, n_rows)] = jnp.asarray(
                    fold_corpus(corpus, 0, n_rows, WF, halo)
                )
            rows = staged[(halo, n_rows)]
            dpat = jnp.asarray(table)
            meta = row_meta(n_rows, WF, bound, 0)
            kw = dict(k=k, m_max=m_max, wf=WF, plens=plens)
            alph = tuple(int(b) for b in build_alphabet(pats))
            steps = [DPStep("pallas")]
            if _myers_mode(k, alph, "myers", table.shape[0], m_max):
                steps.append(DPStep("pallas", False, alph))
            # per-row bounds for the per-row-table epilogue: row r < 256
            # keeps its first (r * 37) % WF windows, later rows keep all
            cut = np.asarray([(r * 37) % WF for r in range(n_mask_rows)])
            meta_b = meta.at[:n_mask_rows, 0].set(
                meta[:n_mask_rows, 1] + jnp.asarray(cut, jnp.int32)
            )
            ref_rows = None
            for dp in steps:
                per_row = np.asarray(dp_scan(rows, dpat, meta, dp=dp, **kw))
                mask = np.asarray(
                    dp_scan(rows[:n_mask_rows], dpat, meta[:n_mask_rows],
                            dp=dp, mask=True, **kw)
                )
                per_row_b = np.asarray(dp_scan(rows, dpat, meta_b, dp=dp, **kw))
                lane = np.arange(WF)[None, None, :]
                from_mask = (mask * (lane < cut[:, None, None])).sum(axis=2)
                assert np.array_equal(mask.sum(axis=2), per_row[:n_mask_rows]), (k, P, dp)
                assert np.array_equal(from_mask, per_row_b[:n_mask_rows]), (k, P, dp)
                assert np.array_equal(per_row_b[n_mask_rows:], per_row[n_mask_rows:])
                if ref_rows is None:
                    ref_rows = per_row
                else:
                    assert np.array_equal(per_row, ref_rows), (k, P, "myers != band")
                checks += 3
            # the plain XLA band (the recurrence of xla_engine.scan_block_xla)
            xla_rows = np.asarray(
                dp_scan(rows[:n_xla_rows], dpat, meta[:n_xla_rows],
                        dp=DPStep("xla"), **kw)
            )
            assert np.array_equal(xla_rows, ref_rows[:n_xla_rows]), (k, P, "xla")
            orc = oracle_rows(corpus, pats, k, oracle_row_ids)
            got = ref_rows[list(oracle_row_ids)][:, :P]
            assert np.array_equal(got, orc), (k, P, "oracle", got, orc)
            checks += 2
            totals = ref_rows.sum(axis=0)[:P]
            raw = np.zeros((P, m_max), np.uint8)
            for i, p in enumerate(pats):
                raw[i, : len(p)] = np.frombuffer(p, np.uint8)
            al = build_alphabet(pats)
            g = _group_rows(WF + halo, len(al), n_rows)
            if k == 0:  # the correlation: exact counts at k = 0
                st = pick_stride(P)
                kern, thr = build_kernel(raw, plens[:P], al, stride=st)
                cc = np.asarray(scan_corr_conv(
                    rows, jnp.asarray(kern), jnp.asarray(thr), jnp.asarray(al),
                    jnp.int32(bound), jnp.int32(0), wf=WF, m_max=m_max,
                    n_rows=n_rows, g_rows=g, stride=st,
                ))
                assert np.array_equal(cc, totals), (P, "corr", cc, totals)
                checks += 1
            elif k <= 2:  # the piece correlation: a sound row superset
                fpl = tuple(
                    m if i < P and filter_eligible(m, k) else 0
                    for i, m in enumerate(plens)
                )
                if any(fpl):
                    npc = sum(tier_of(m, k)[0] for m in fpl if m)
                    st = pick_stride(npc)
                    pk, pt, ow = build_piece_kernel(
                        np.pad(raw, ((0, len(plens) - P), (0, 0))), fpl, k, al,
                        stride=st,
                    )
                    _, rowmap = scan_pieces_conv(
                        rows, jnp.asarray(pk), jnp.asarray(pt), jnp.asarray(ow),
                        jnp.asarray(al), jnp.int32(bound), jnp.int32(0),
                        wf=WF, w_kern=pk.shape[0], n_rows=n_rows, g_rows=g,
                        stride=st,
                    )
                    rowmap = np.asarray(rowmap)
                    for i, m in enumerate(fpl):
                        if m:
                            hit_rows = ref_rows[:, i] > 0
                            assert not (hit_rows & (rowmap[:, i] == 0)).any(), (
                                k, P, i, "piece conv missed a matching row"
                            )
                    checks += 1
            log(
                f"conformance k={k} P={P} m_max={m_max} modes={len(steps)} "
                f"matches={int(totals.sum())} ok"
            )
        jax.clear_caches()
    log(f"conformance: {checks} exact comparisons passed")


# -- phase 4 -------------------------------------------------------------


def host_exact_count(corpus_b: bytes, pat: bytes) -> int:
    n, i = 0, corpus_b.find(pat)
    while i != -1:
        n += 1
        i = corpus_b.find(pat, i + 1)
    return n


def expected_counts(corpus, pats, k, plants, tail=256):
    """Oracle counts: every plant's neighbourhood plus the EOF tail. A
    random 50-byte window away from a plant is within distance 2 of a
    pattern with probability far below 1e-20."""
    from apm.utils.oracle import banded_distances, count_matches

    n = len(corpus)
    m_max = max(len(p) for p in pats)
    spans = []
    for pos, _ in plants:
        lo, hi = max(0, pos - m_max - 8), min(n - tail, pos + m_max + 8)
        if spans and lo <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], hi)
        elif lo < hi:
            spans.append([lo, hi])
    out = np.asarray(count_matches(corpus[n - tail :], list(pats), k), np.int64)
    for lo, hi in spans:
        for pi, p in enumerate(pats):
            seg = corpus[lo : hi + len(p) - 1 + k]
            out[pi] += int(np.sum(banded_distances(seg, p, k)[: hi - lo] <= k))
    return out


def main_path_phase():
    import apm
    from apm.cli import main as cli_main
    from apm.utils.corpus import reference_shaped
    from apm.utils.oracle import count_matches

    n = MAIN_BYTES
    corpus, line, absent, plants = reference_shaped(
        n, seed=SEED, exact=40, fuzzy=40
    )
    corpus.setflags(write=False)
    pats = [absent] + [line] * 5
    log(f"main path: {n >> 20} MB corpus, {len(plants)} plants")
    # k = 0 gate: substring count of the untruncated windows plus the
    # oracle over each pattern's m - 1 EOF-truncated ones.
    corpus_b = corpus.tobytes()
    want0 = [
        host_exact_count(corpus_b, p)
        + count_matches(corpus[n - (len(p) - 1) :], [p], 0)[0]
        for p in pats
    ]
    del corpus_b
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "ref_shaped.fa")
        corpus.tofile(path)
        for k in (0, 1, 2):
            want = want0 if k == 0 else expected_counts(corpus, pats, k, plants).tolist()
            sc = apm.Scanner(pats, k)
            t0 = time.perf_counter()
            got = sc.count(corpus).tolist()
            t1 = time.perf_counter() - t0
            plan = sc.last_plan
            log(f"k={k} plan={plan}")
            assert plan is not None and plan.dp.impl == "pallas", plan
            assert not plan.dp.interpret, plan
            assert got == want, (k, got, want)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main([str(k), path, *(p.decode() for p in pats)])
            # the 50-byte line ends in a newline, so its echo spans two lines
            cli = [int(c) for c in re.findall(r">: (\d+)$", buf.getvalue(), re.M)]
            assert rc == 0 and cli == want, (k, rc, cli, want)
            log(f"k={k} Scanner.count == CLI == oracle gate {got} "
                f"(first call {t1:.2f}s incl. compile)")
            del sc
    return corpus, line, absent, plants


# -- phase 5 -------------------------------------------------------------


def serving_phase(corpus, line, absent, plants):
    import apm
    from apm.utils.oracle import banded_distances, count_matches

    pats = [absent, line, line[:30]]
    k = 1
    sc = apm.Scanner(pats, k)
    n = len(corpus)
    cuts = [(0, 150), (1000, 1 << 20), (n // 100, n // 100 + n // 32),
            (n // 8, n // 4), (n // 2, n // 2 + 4095), (n - 777, n)]
    corpora = [corpus[a:b] for a, b in cuts]
    got = sc.count_batch(corpora)
    for b, c in enumerate(corpora):
        one = sc.count(c).tolist()
        assert got[b].tolist() == one, (b, got[b].tolist(), one)
        if len(c) <= (1 << 20):
            assert one == count_matches(c, pats, k), (b, one)
    log(f"count_batch: {len(corpora)} corpora == count() == oracle (small ones)")

    lo, hi = n // 8, n // 4
    sub = corpus[lo:hi]
    sub_plants = [(p - lo, s) for p, s in plants if lo <= p < hi - 200]
    pos = sc.find(sub)
    counts = sc.count(sub)
    want = expected_counts(sub, pats, k, sub_plants)
    for pi, p in enumerate(pats):
        assert len(pos[pi]) == counts[pi] == want[pi], (pi, len(pos[pi]), counts[pi], want[pi])
        for j in pos[pi][:50]:
            d = banded_distances(sub[j : j + len(p) + k], p, k)[0]
            assert d <= k, (pi, j, d)
    log(f"find: {[len(x) for x in pos]} positions == count() == oracle")


# -- phase 6 -------------------------------------------------------------


def ab_phase(corpus, line, absent, smi):
    """End-to-end A/B through Scanner.count: the Triton DP kernel against
    the plain XLA band, in alternating turns on the same card."""
    import apm
    from apm.utils.config import ApmConfig
    from apm.utils.corpus import random_pattern

    sub = corpus[:AB_BYTES]
    pats_ref = [absent] + [line] * 5
    p50 = [bytes(random_pattern(50, seed=s)) for s in (1, 2)]
    big, small = f"{len(corpus) >> 20}MB", f"{len(sub) >> 20}MB"
    cells = [
        (f"{big} ref set k=2 auto (filtration + DP verify)", corpus, pats_ref, 2, "auto"),
        (f"{small} ref set k=1 dp", sub, pats_ref, 1, "dp"),
        (f"{small} ref set k=2 dp", sub, pats_ref, 2, "dp"),
        (f"{small} 2x50 k=4 dp", sub, p50, 4, "dp"),
        (f"{small} 2x50 k=8 dp", sub, p50, 8, "dp"),
        (f"{small} 2x50 k=12 dp", sub, p50, 12, "dp"),
    ]
    rows = []
    for name, c, pats, k, engine in cells:
        res = {}
        scs = {
            b: apm.Scanner(pats, k, ApmConfig(backend=b, engine=engine))
            for b in ("pallas", "xla")
        }
        counts = {b: scs[b].count(c).tolist() for b in scs}
        assert counts["pallas"] == counts["xla"], (name, counts)
        for b in ("pallas", "xla", "xla", "pallas"):
            res.setdefault(b, []).append(timed(lambda: scs[b].count(c), reps=3))
        kern, xla = min(res["pallas"]), min(res["xla"])
        rows.append({
            "cell": name, "kernel_s": kern, "xla_s": xla,
            "kernel_mb_s": len(c) / kern / 1e6, "xla_mb_s": len(c) / xla / 1e6,
            "speedup": xla / kern, "dp": str(scs["pallas"].dp_step()),
        })
        log(f"A/B {name}: kernel {len(c) / kern / 1e6:.1f} MB/s, "
            f"XLA band {len(c) / xla / 1e6:.1f} MB/s, x{xla / kern:.1f} "
            f"[{smi}]")
        del scs
    log("A/B rows: " + json.dumps({"card": smi, "cells": rows}))


# -- --four ----------------------------------------------------------------


def four_phase(smi):
    """1 GiB at k = 0 and k = 1 under both strategies on four cards vs a
    one-card count() of the same corpus."""
    import apm
    from apm.utils.config import ApmConfig
    from apm.utils.corpus import reference_shaped

    n = FOUR_BYTES
    corpus, line, absent, _ = reference_shaped(n, seed=SEED, exact=64, fuzzy=64)
    corpus.setflags(write=False)
    pats = [absent] + [line] * 5
    for k in (0, 1):
        one = apm.Scanner(pats, k, ApmConfig(strategy="single"))
        want = one.count(corpus).tolist()
        t_one = timed(lambda: one.count(corpus), reps=1)
        del one
        for strategy in ("database_over_devices", "patterns_over_devices"):
            sc = apm.Scanner(pats, k, ApmConfig(strategy=strategy, max_devices=4))
            got = sc.count(corpus).tolist()
            assert sc.last_strategy == strategy, sc.last_strategy
            assert got == want, (k, strategy, got, want)
            t = timed(lambda: sc.count(corpus), reps=1)
            log(f"--four k={k} {strategy}: {got} == one card {want}; "
                f"{n / t / 1e6:.0f} MB/s vs one card {n / t_one / 1e6:.0f} MB/s "
                f"[{smi}]")
            del sc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded 1 GiB scan on four GPUs")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    devs, smi = device_check(4 if args.four else 1)
    if args.four:
        four_phase(smi)
    else:
        compile_phase()
        conformance_phase()
        corpus, line, absent, plants = main_path_phase()
        serving_phase(corpus, line, absent, plants)
        ab_phase(corpus, line, absent, smi)
    print(smi, flush=True)
    d = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
