"""Multi-device distribution strategies (GSPMD / shard_map).

Re-design of the reference's two MPI strategies. Where the reference mails
bytes between ranks (``MPI_Bcast``/``Send``/``Recv``,
``src/patterns_over_ranks.c:139-207``, ``src/database_over_ranks.c:119-195``),
here shards are *placed* on devices via ``jax.sharding.NamedSharding`` and the
only runtime communication is one ``psum``/gather of the tiny per-pattern
count vector (NCCL between GPUs).

* ``database_over_devices`` — the analog of strategy B
  (``src/database_over_ranks.c``): the corpus window axis is sharded across
  the ``data`` mesh axis; each device's shard carries a host-materialized
  halo (the moral equivalent of the ``(m-1)``-byte halo at
  ``database_over_ranks.c:339-343``); per-pattern counts are combined with
  ``jax.lax.psum``. Unlike the reference — which double-counts windows in
  the halo seam (Report §4.3) — every window start is owned by exactly one
  shard.
* ``patterns_over_devices`` — the analog of strategy A
  (``src/patterns_over_ranks.c``): each device runs the full single-device
  pipeline over its own pattern group, the corpus placed on every device
  (the Bcast analog); no reduction needed.

There is no master rank, no poison pill, no tag demuxing — the cost model
that chose between MPI strategies largely dissolves (see apm.parallel.plan
for what remains).
"""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.common import fold_corpus, round_up

if TYPE_CHECKING:  # pragma: no cover
    from ..models.scanner import Scanner


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.partial(
    jax.jit, static_argnames=("mesh", "k", "m_max", "wf", "plens", "dp")
)
def _database_sharded(shards, starts, pat, bound, *, mesh, k, m_max, wf, plens, dp):
    """Sharded banded DP: each device scans its own window shard with the
    DP step of ``dp`` (the kernel or the plain XLA band), one psum joins
    the counts."""
    from ..ops.pallas_kernel import dp_count

    def body(shard, start, pat, bound):
        counts = dp_count(
            shard[0], pat, bound, start[0],
            k=k, m_max=m_max, wf=wf, plens=plens, dp=dp,
        )
        return jax.lax.psum(counts, "data")

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("data", None, None), P("data"), P(None, None), P()),
        out_specs=P(None),
        check_vma=False,
    )(shards, starts, pat, bound)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "wf", "m_max", "n_rows", "g_rows", "stride", "p_out"
    ),
)
def _corr_sharded(
    shards, starts, kern, thr, alph, bound, *, mesh, wf, m_max, n_rows,
    g_rows, stride=1, p_out=0,
):
    """Sharded k = 0 correlation scan (apm.ops.corr_engine): each device
    convolves its own window shard, one psum joins the counts."""
    from ..ops.corr_engine import scan_corr_conv

    def body(shard, start, kern, thr, alph, bound):
        counts = scan_corr_conv(
            shard[0], kern, thr, alph, bound, start[0],
            wf=wf, m_max=m_max, n_rows=n_rows, g_rows=g_rows,
            stride=stride, p_out=p_out,
        )
        return jax.lax.psum(counts, "data")

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P("data", None, None), P("data"), P(None, None, None), P(None),
            P(None), P(),
        ),
        out_specs=P(None),
        check_vma=False,
    )(shards, starts, kern, thr, alph, bound)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "k", "m_max", "wf", "plens", "w_kern", "n_rows", "g_rows",
        "fp1_stride", "dp",
    ),
)
def _filter_verify_conv_sharded(
    shards, starts, pkern, pthr, owner, alph, pat, bound, *, mesh, k, m_max,
    wf, plens, w_kern, n_rows, g_rows, fp1_stride, dp,
):
    """Sharded filtration phase 1 + on-device verification (k >= 1).

    Each device verifies its own shard's hot rows (gathered straight from
    the device-resident staging rows, see ``apm.ops.fused``); the
    per-pattern candidate and verified totals ride one ``psum`` each, and
    the tiny per-shard hot-row counts / clipped-row starts are
    ``all_gather``-replicated so every process sees identical values (no
    host ever reads another host's shard). Everything the host needs
    comes back as ONE replicated int32 vector — layout ``[fcnt (P) |
    vcnt (P) | n_hot (D) | clip_starts (D*MAX_CLIP)]``. Row maps stay
    device-sharded, fetched only by single-process overflow recovery.
    """
    from ..ops.fused import filter_verify_chunk_conv

    def body(shard, start, pkern, pthr, owner, alph, pat, bound):
        packed, rowmap = filter_verify_chunk_conv(
            shard[0], pkern, pthr, owner, alph, pat, bound, start[0],
            k=k, m_max=m_max, wf=wf, plens=plens,
            w_kern=w_kern, n_rows=n_rows, g_rows=g_rows,
            fp1_stride=fp1_stride, dp=dp,
        )
        return _collective_pack(packed, pat.shape[0]), rowmap[None]

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P("data", None, None), P("data"), P(None, None, None), P(None),
            P(None, None), P(None), P(None, None), P(),
        ),
        out_specs=(P(None), P("data", None, None)),
        check_vma=False,
    )(shards, starts, pkern, pthr, owner, alph, pat, bound)


def _collective_pack(packed, p: int):
    """Shared sharded packing of a fused chunk's ``packed`` vector: psum
    the per-pattern candidate/verified totals, all_gather the per-shard
    hot-row count and clipped-row starts, so every process fetches ONE
    identical replicated vector (layout: ``[fcnt (P) | vcnt (P) |
    n_hot (D) | clip_starts (D*MAX_CLIP)]``)."""
    fcnt, vcnt = packed[:p], packed[p : 2 * p]
    n_hot, clip_starts = packed[2 * p : 2 * p + 1], packed[2 * p + 1 :]
    return jnp.concatenate(
        [
            jax.lax.psum(fcnt, "data"),
            jax.lax.psum(vcnt, "data"),
            jax.lax.all_gather(n_hot, "data").reshape(-1),
            jax.lax.all_gather(clip_starts, "data").reshape(-1),
        ]
    )


def _unpack_sharded(packed, p: int, n_dev: int):
    """Split a fetched sharded ``packed`` vector: (fcnt, vcnt, n_hots (D,),
    clip_starts (D, MAX_CLIP))."""
    from ..ops.fused import MAX_CLIP

    packed = np.asarray(packed)
    fcnt = packed[:p]
    vcnt = packed[p : 2 * p]
    n_hots = packed[2 * p : 2 * p + n_dev]
    clips = packed[2 * p + n_dev :].reshape(n_dev, MAX_CLIP)
    return fcnt, vcnt, n_hots, clips


def sharded_filter_chunks(
    scanner, plan, mesh, shards, starts, dpat, dbound,
    *, rows_per, s, n_dev, p_pad, single_proc,
):
    """Dispatch the sharded filtration (k >= 1) and assemble
    ``finalize_filtration``'s inputs.

    One body for both distribution entry points (``database_over_devices``
    and ``count_multihost``): fetches the replicated packed vector once,
    and returns ``(fchunks, rescan)`` where ``fchunks`` carry a lazy
    row-map fetch (single-process only — multi-process overflow recovery
    uses the banded ``rescan``, since no host can address another host's
    shards).
    """
    from ..models.pipeline import FilterChunk
    from ..ops.corr_engine import _group_rows

    k, m_max, wf = scanner.k, scanner.m_max, plan.wf
    pk_np, pt_np, ow_np, fp1_stride = scanner._fp1_kernel(plan.plens_filter)
    alph = scanner._corr_alphabet()
    packed, rowmaps = _filter_verify_conv_sharded(
        shards, starts,
        jax.device_put(pk_np, NamedSharding(mesh, P(None, None, None))),
        jax.device_put(pt_np, NamedSharding(mesh, P(None))),
        jax.device_put(ow_np, NamedSharding(mesh, P(None, None))),
        jax.device_put(alph, NamedSharding(mesh, P(None))),
        dpat, dbound,
        mesh=mesh, k=k, m_max=m_max, wf=wf, plens=plan.plens_filter,
        w_kern=pk_np.shape[0], n_rows=rows_per,
        g_rows=_group_rows(wf + plan.halo, len(alph), rows_per),
        fp1_stride=fp1_stride, dp=plan.dp,
    )

    rm_cache: dict = {}

    def fetch_rowmap(d):
        if "rm" not in rm_cache:
            rm_cache["rm"] = np.asarray(rowmaps)
        return rm_cache["rm"][d]

    fcnt, vcnt, n_hots, clips = _unpack_sharded(packed, p_pad, n_dev)
    fchunks = [
        FilterChunk(
            d * s,
            fcnt if d == 0 else None,
            vcnt if d == 0 else None,
            n_hots[d],
            clips[d],
            (lambda d=d: fetch_rowmap(d)) if single_proc else None,
        )
        for d in range(n_dev)
    ]

    def rescan() -> np.ndarray:
        dev = _database_sharded(
            shards, starts, dpat, dbound,
            mesh=mesh, k=k, m_max=m_max, wf=wf, plens=plan.plens_filter,
            dp=plan.dp,
        )
        return np.asarray(dev).astype(np.int64)

    return fchunks, rescan


def count_database_over_devices(scanner: "Scanner", buf: np.ndarray, n_dev: int) -> np.ndarray:
    """Shard the window axis over ``n_dev`` devices with host-side halos.

    Window ownership: shard ``d`` owns starts ``[d*s, (d+1)*s)`` intersected
    with the device window bound; the EOF tail is counted host-side once
    (see ``Scanner.tail_counts``).
    """
    from ..models.pipeline import buf_reader, finalize_filtration, make_plan
    from ..ops.fused import MAX_HOT

    k, m_max = scanner.k, scanner.m_max
    n = len(buf)
    plan = scanner.last_plan = make_plan(scanner, n)
    wf, halo, dev_bound = plan.wf, plan.halo, plan.dev_bound

    devices = np.asarray(jax.devices()[:n_dev])
    mesh = Mesh(devices, ("data",))
    rep = NamedSharding(mesh, P())
    p_pad = scanner._pat.shape[0]
    counts = np.zeros((p_pad,), dtype=np.int64)
    if dev_bound > 0:
        s = max(round_up(_cdiv(dev_bound, n_dev), plan.w), plan.w)
        rows_per = s // wf
        shards = np.stack(
            [fold_corpus(buf, d * s, rows_per, wf, halo) for d in range(n_dev)]
        )
        starts = np.arange(n_dev, dtype=np.int32) * s
        dshards = jax.device_put(
            shards, NamedSharding(mesh, P("data", None, None))
        )
        dstarts = jax.device_put(starts, NamedSharding(mesh, P("data")))
        dbound = jax.device_put(np.int32(dev_bound), rep)
        dpat = jax.device_put(scanner._pat, NamedSharding(mesh, P(None, None)))
        if plan.use_corr:
            counts += _sharded_corr(
                scanner, mesh, dshards, dstarts, dbound, plan, rows_per
            )
        if plan.any_dp:
            dev = _database_sharded(
                dshards, dstarts, dpat, dbound,
                mesh=mesh, k=k, m_max=m_max, wf=wf, plens=plan.plens_dp,
                dp=plan.dp,
            )
            counts += np.asarray(dev)
        if plan.any_filter:
            fchunks, rescan = sharded_filter_chunks(
                scanner, plan, mesh, dshards, dstarts, dpat, dbound,
                rows_per=rows_per, s=s, n_dev=n_dev, p_pad=p_pad,
                single_proc=True,
            )
            counts += finalize_filtration(
                scanner, buf_reader(buf), plan, n, fchunks, rescan,
                max_hot=MAX_HOT,
            )
    counts[: scanner.scan_patterns.num_patterns] += scanner.tail_counts(
        buf, dev_bound
    )
    return counts


def _sharded_corr(scanner, mesh, shards, starts, bound, plan, rows_per):
    """k = 0 correlation over a window-sharded corpus (one psum)."""
    from ..ops.corr_engine import _group_rows

    kern_np, thr_np, corr_stride = scanner._corr_kernel()
    alph = scanner._corr_alphabet()
    dev = _corr_sharded(
        shards, starts,
        jax.device_put(kern_np, NamedSharding(mesh, P(None, None, None))),
        jax.device_put(thr_np, NamedSharding(mesh, P(None))),
        jax.device_put(alph, NamedSharding(mesh, P(None))),
        bound,
        mesh=mesh, wf=plan.wf, m_max=scanner.m_max, n_rows=rows_per,
        g_rows=_group_rows(plan.wf + plan.halo, len(alph), rows_per),
        stride=corr_stride, p_out=scanner._pat.shape[0],
    )
    return np.asarray(dev)


def _pattern_groups(scanner: "Scanner", n_dev: int):
    """Length-balanced pattern assignment: greedy least-loaded binning by
    pattern length (scan cost per pattern is ~linear in m for both the
    banded and filtration kernels)."""
    p = scanner.scan_patterns.num_patterns
    n_use = max(1, min(n_dev, p))
    order = sorted(range(p), key=lambda i: -len(scanner.scan_patterns.raw[i]))
    groups = [[] for _ in range(n_use)]
    loads = [0] * n_use
    for i in order:
        d = loads.index(min(loads))
        groups[d].append(i)
        loads[d] += max(len(scanner.scan_patterns.raw[i]), 1)
    return [sorted(g) for g in groups]


def count_patterns_over_devices(scanner: "Scanner", buf: np.ndarray, n_dev: int) -> np.ndarray:
    """Shard the pattern axis over ``n_dev`` devices; corpus replicated.

    Placement-parallel per-device scans: reference strategy A has *zero*
    runtime communication (each rank owns its patterns end to end,
    ``patterns_over_ranks.c:139-207``), so nothing requires a single
    program. Each device gets a length-balanced pattern group and runs the
    FULL single-device pipeline (static lengths per group) with its inputs
    placed on that device; dispatch happens from one thread per device so
    device work overlaps, and only the tiny per-group count vectors come
    back.
    """
    from concurrent.futures import ThreadPoolExecutor

    n = len(buf)
    w = scanner.block_windows_for(n)
    groups = _pattern_groups(scanner, n_dev)
    devices = jax.devices()[: len(groups)]
    subs = scanner._pattern_shard_scanners(groups, block_windows=w)
    fp = scanner._corpus_fp(buf)

    def run(d: int) -> np.ndarray:
        with jax.default_device(devices[d]):
            return subs[d]._count_pipeline(buf, n, fp=fp)

    if len(groups) == 1:
        outs = [run(0)]
    else:
        with ThreadPoolExecutor(len(groups)) as ex:
            outs = list(ex.map(run, range(len(groups))))
    scanner.last_plan = subs[0].last_plan
    counts = np.zeros((scanner._pat.shape[0],), dtype=np.int64)
    for d, g in enumerate(groups):
        for slot, pi in enumerate(g):
            counts[pi] = outs[d][slot]
    return counts


def count_distributed(scanner: "Scanner", buf: np.ndarray, strategy: str, n_dev: int) -> np.ndarray:
    if strategy == "database_over_devices":
        return count_database_over_devices(scanner, buf, n_dev)
    if strategy == "patterns_over_devices":
        return count_patterns_over_devices(scanner, buf, n_dev)
    raise ValueError(f"unknown distribution strategy {strategy!r}")
