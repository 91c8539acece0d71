"""Multi-host (multi-process) distributed scan.

The reference's multi-node story is ``salloc -N nodes mpirun`` + every rank
reading the input file from the shared FS (``database_over_ranks.c:215``,
Report §4.1). The equivalent here:

* :func:`initialize` — ``jax.distributed.initialize()`` replaces
  ``MPI_Init``/``mpirun`` process bootstrap;
* :func:`count_multihost` — each host stages **only the folded rows its own
  local devices will scan** (``native.read_folded`` straight from the file:
  no host ever materializes the whole corpus, unlike the reference where
  every rank slurps the full file), assembles the globally-sharded array
  with ``jax.make_array_from_single_device_arrays``, and runs the same
  jitted ``shard_map`` program as the single-host database strategy. The
  per-pattern count ``psum`` rides the devices' interconnect (NCCL on
  GPUs) — behind the same program;
* host 0 (``jax.process_index() == 0``) computes the EOF tail with the
  oracle and owns printing, mirroring rank 0's role (without being a
  master — all hosts run the same program).

Degrades to the single-host database strategy when there is one process, so
the same code path is exercised by the virtual-device test mesh.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.common import round_up
from .strategies import _cdiv, _database_sharded

if TYPE_CHECKING:  # pragma: no cover
    from ..models.scanner import Scanner


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bootstrap the multi-process runtime (MPI_Init analog).

    With no arguments, jax autodetects the cluster environment (SLURM,
    Open MPI, GKE); elsewhere pass all three. No-op when already
    initialized or single-process.
    """
    if jax.process_count() > 1:
        return  # already initialized
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError):
        pass  # single-process / already initialized


def _stage_rows(path: str, offset_bytes: int, n_rows: int, wf: int, halo: int) -> np.ndarray:
    """Folded staging rows for one device's shard, read straight from disk."""
    from ..utils import native

    if native.available():
        return native.read_folded(path, offset_bytes, n_rows, wf, halo)
    # Fallback: range-read via numpy then fold.
    from ..ops.common import fold_corpus

    total = n_rows * wf + halo
    buf = np.fromfile(path, dtype=np.uint8, count=offset_bytes + total)
    return fold_corpus(buf, offset_bytes, n_rows, wf, halo)


def count_multihost(scanner: "Scanner", path: str) -> np.ndarray:
    """Scan a corpus file across every device of every host.

    Returns the per-pattern counts (valid on every host; host 0 prints).
    """
    from ..models.pipeline import file_reader, finalize_filtration, make_plan
    from ..ops.fused import MAX_HOT
    from .strategies import _sharded_corr, sharded_filter_chunks

    k, m_max = scanner.k, scanner.m_max
    n = os.path.getsize(path)
    plan = scanner.last_plan = make_plan(scanner, n)
    w, wf, halo, dev_bound = plan.w, plan.wf, plan.halo, plan.dev_bound

    devices = np.asarray(jax.devices())  # global device order
    n_dev = len(devices)
    mesh = Mesh(devices, ("data",))
    rep = NamedSharding(mesh, P())
    row_sharding = NamedSharding(mesh, P("data", None, None))
    start_sharding = NamedSharding(mesh, P("data"))

    p_pad = scanner._pat.shape[0]
    counts = np.zeros((p_pad,), dtype=np.int64)
    if dev_bound > 0:
        s = max(round_up(_cdiv(dev_bound, n_dev), w), w)
        rows_per = s // wf

        local_rows = []
        local_starts = []
        for gi, dev in enumerate(devices):
            if dev.process_index != jax.process_index():
                continue
            staged = _stage_rows(path, gi * s, rows_per, wf, halo)
            local_rows.append(jax.device_put(staged[None], dev))
            local_starts.append(
                jax.device_put(np.asarray([gi * s], dtype=np.int32), dev)
            )
        shards = jax.make_array_from_single_device_arrays(
            (n_dev, rows_per, wf + halo), row_sharding, local_rows
        )
        starts = jax.make_array_from_single_device_arrays(
            (n_dev,), start_sharding, local_starts
        )
        # The device owns windows [0, dev_bound); the EOF tail is added
        # below.
        dbound = jax.device_put(np.int32(dev_bound), rep)
        dpat = jax.device_put(scanner._pat, NamedSharding(mesh, P(None, None)))

        if plan.use_corr:
            counts += _sharded_corr(
                scanner, mesh, shards, starts, dbound, plan, rows_per
            )
        if plan.any_dp:
            dev_counts = _database_sharded(
                shards, starts, dpat, dbound,
                mesh=mesh, k=k, m_max=m_max, wf=wf, plens=plan.plens_dp,
                dp=plan.dp,
            )
            counts += np.asarray(dev_counts)
        if plan.any_filter:
            # Row maps are device-sharded; only a single process can
            # fetch them all. Multi-process overflow recovery falls back
            # to the banded rescan inside finalize_filtration.
            fchunks, rescan = sharded_filter_chunks(
                scanner, plan, mesh, shards, starts, dpat, dbound,
                rows_per=rows_per, s=s, n_dev=n_dev, p_pad=p_pad,
                single_proc=jax.process_count() == 1,
            )
            counts += finalize_filtration(
                scanner, file_reader(path), plan, n, fchunks,
                rescan, max_hot=MAX_HOT,
            )

    # EOF tail: tiny; every host computes it identically (no broadcast needed).
    counts[: scanner.scan_patterns.num_patterns] += _read_tail(
        path, dev_bound, n, k, scanner
    )
    return counts


def _read_tail(path: str, dev_bound: int, n: int, k: int, scanner: "Scanner") -> np.ndarray:
    from ..utils import native
    from ..utils.oracle import count_matches

    p = scanner.scan_patterns.num_patterns
    out = np.zeros((p,), dtype=np.int64)
    if dev_bound >= max(n - k, 0):
        return out
    length = n - dev_bound
    if native.available():
        tail = native.read_range(os.fspath(path), dev_bound, length)
    else:
        with open(path, "rb") as f:
            f.seek(dev_bound)
            tail = np.frombuffer(f.read(length), dtype=np.uint8)
    out[:] = count_matches(tail, list(scanner.scan_patterns.raw), k)
    return out
