"""Multi-host feeder exercised in single-process mode on the virtual mesh.

``count_multihost`` stages per-device shards straight from the file (never
materializing the corpus on any host) and assembles the global array with
``make_array_from_single_device_arrays`` — in single-process mode that is
bit-identical plumbing to a real multi-host run minus DCN.
"""

import os
import tempfile

import jax
import numpy as np
import pytest

from apm.models.scanner import Scanner
from apm.parallel.multihost import count_multihost
from apm.utils.config import ApmConfig
from apm.utils.oracle import count_matches
from tests.conftest import random_dna


@pytest.fixture(scope="module", autouse=True)
def need_8_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


@pytest.fixture()
def corpus_file():
    data = random_dna(7000, seed=55)
    with tempfile.NamedTemporaryFile(suffix=".fa", delete=False) as f:
        f.write(data.tobytes())
        path = f.name
    yield path, data
    os.unlink(path)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("k", [0, 2])
def test_multihost_vs_oracle(corpus_file, backend, k):
    path, data = corpus_file
    pats = [random_dna(m, seed=70 + m) for m in [10, 33, 50]]
    cfg = ApmConfig(
        backend=backend,
        interpret=(backend == "pallas"),
        block_windows=1024,
    )
    sc = Scanner(pats, k, cfg)
    counts = count_multihost(sc, path)
    got = [int(c) for c in counts[: len(pats)]]
    assert got == count_matches(data, pats, k)


def test_multihost_matches_single(corpus_file):
    path, data = corpus_file
    pats = [random_dna(25, seed=81)]
    cfg = ApmConfig(backend="xla", block_windows=1024, strategy="single")
    sc = Scanner(pats, 1, cfg)
    single = sc.count(data).tolist()
    multi = [int(c) for c in count_multihost(sc, path)[:1]]
    assert multi == single


def test_count_file_streams(corpus_file):
    """count_file (memmap streaming) == count (in-memory slurp)."""
    path, data = corpus_file
    pats = [random_dna(20, seed=91), random_dna(50, seed=92)]
    for backend, interp in [("xla", False), ("pallas", True)]:
        cfg = ApmConfig(backend=backend, interpret=interp, block_windows=1024)
        sc = Scanner(pats, 1, cfg)
        assert sc.count_file(path).tolist() == sc.count(data).tolist()


def _run_two_procs(tmp_path, data, k, patterns, extra_env=None):
    """Spawn the 2-process x 4-device cluster over localhost and return
    the per-process result dicts (counts, rescan_calls, ...)."""
    import json
    import socket
    import subprocess
    import sys

    path = str(tmp_path / "corpus.fa")
    with open(path, "wb") as f:
        f.write(data.tobytes())
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))
    env.pop("XLA_FLAGS", None)
    env.update(extra_env or {})
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    outs = [str(tmp_path / f"out{i}.json") for i in range(2)]
    procs = [
        subprocess.Popen(
            [
                sys.executable, worker, str(port), str(i), "2", path,
                str(k), outs[i],
            ] + [np.asarray(p).tobytes().decode() for p in patterns],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err
    results = []
    for i in range(2):
        with open(outs[i]) as f:
            results.append(json.load(f))
        assert results[i]["process_count"] == 2
    return results


@pytest.mark.parametrize("k", [0, 1])
def test_multihost_two_processes(tmp_path, k):
    """REAL multi-process run: 2 spawned processes x 4 virtual devices,
    jax.distributed over localhost — exercises the process bootstrap and
    the make_array_from_single_device_arrays cross-process assembly
    (the analog of database_over_ranks.c:119-166 multi-node semantics),
    which round 1 only ever ran single-process."""
    from apm.utils.corpus import plant, random_pattern

    data = random_dna(6000, seed=131)
    pat = random_pattern(24, seed=132)
    if k > 0:
        plant(data, pat, [400, 2900, 5200], k=k, seed=133)
    want = count_matches(data, [pat], k)
    for res in _run_two_procs(tmp_path, data, k, [pat]):
        assert res["counts"] == want, (res, want)
    if k > 0:
        assert want[0] >= 3


def test_multihost_two_processes_mixed_overflow_rescan(tmp_path):
    """2-process mixed-eligibility scan, k = 2, with one shard driven past
    the (shrunken) verify bucket: multi-process overflow cannot fetch the
    sharded row maps (rowmap=None), so finalize_filtration MUST recover
    through the banded rescan — asserted via the worker's rescan-call
    counter, executing multihost.py's multi-process overflow branch for
    real."""
    from apm.utils.corpus import plant, random_pattern

    k = 2
    data = random_dna(40000, seed=141)
    short = random_pattern(6, seed=142)  # ineligible -> banded DP path
    elig = random_pattern(48, seed=143)  # exact tier (pieces of 16)
    # wf = block_windows/8 = 1024/8 = 128 windows/row; shard s ~ 5k
    # windows. 12 plants in distinct rows of shard 0 (> MAX_HOT=8
    # overflow), a few in later shards; total hot rows << the density
    # threshold (max(64, dev_bound/2560) = 64), so the rescan comes from
    # the OVERFLOW branch, not the density fallback.
    plants0 = [200 + r * 128 for r in range(12)]
    plants_rest = [17000 + r * 128 for r in range(5)] + [36000, 38000]
    plant(data, elig, plants0 + plants_rest, k=k, seed=144)
    want = count_matches(data, [short, elig], k)
    assert want[1] >= 19
    for res in _run_two_procs(
        tmp_path, data, k, [short, elig],
        extra_env={"APM_TEST_MAXHOT": "8"},
    ):
        assert res["counts"] == want, (res, want)
        assert res["rescan_calls"] >= 1, res


def test_multihost_two_processes_banded_tier(tmp_path):
    """2-process k = 6 scan of a banded-tier-length pattern (no
    correlation phase 1: banded DP) mixed with a short pattern, across
    process boundaries."""
    from apm.utils.corpus import plant, random_pattern

    k = 6
    data = random_dna(12000, seed=151)
    short = random_pattern(10, seed=152)  # ineligible at k=6 -> DP
    banded = random_pattern(64, seed=153)  # banded tier at k=6
    plant(data, banded, [500, 5200, 11000], k=k, seed=154)
    want = count_matches(data, [short, banded], k)
    assert want[1] >= 3
    for res in _run_two_procs(tmp_path, data, k, [short, banded]):
        assert res["counts"] == want, (res, want)


def test_multihost_filtration_with_plants(corpus_file):
    """File-backed filtration across the mesh: planted matches recovered."""
    from apm.utils.corpus import plant, random_pattern

    path, data = corpus_file
    pat = random_pattern(50, seed=61)
    mutable = data.copy()
    plant(mutable, pat, [500, 3000, 6500], k=2, seed=62)
    import tempfile, os as _os

    with tempfile.NamedTemporaryFile(suffix=".fa", delete=False) as f:
        f.write(mutable.tobytes())
        path2 = f.name
    try:
        cfg = ApmConfig(backend="pallas", interpret=True, block_windows=1024)
        sc = Scanner([pat], 2, cfg)
        got = [int(c) for c in count_multihost(sc, path2)[:1]]
        want = count_matches(mutable, [pat], 2)
        assert got == want
        assert want[0] >= 3
    finally:
        _os.unlink(path2)
