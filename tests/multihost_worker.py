"""Worker process for the 2-process multihost tests (not a test module).

Each worker owns 4 virtual CPU devices; together they form the 8-device
"cluster". Usage:

    python tests/multihost_worker.py <coord_port> <process_id> <num_procs> \
        <corpus_path> <k> <out_json> <pattern...>

Env knobs (set by the tests):

* ``APM_TEST_MAXHOT`` — shrink ``apm.ops.fused.MAX_HOT`` so a small
  corpus can overflow the per-shard verify bucket (the multi-process
  overflow -> banded-rescan branch needs > MAX_HOT hot rows on a shard).
* The worker always records ``rescan_calls`` — how many times
  ``finalize_filtration``'s fallback rescan ran — so tests can assert
  WHICH recovery branch executed, not just that counts came out right.
"""

import json
import os
import sys


def main() -> None:
    port, pid, nproc, corpus_path, k, out_json = sys.argv[1:7]
    patterns = [p.encode() for p in sys.argv[7:]]

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=int(nproc),
        process_id=int(pid),
    )
    assert jax.process_count() == int(nproc), jax.process_count()
    assert len(jax.devices()) == 4 * int(nproc)

    import apm.models.pipeline as pipeline
    from apm.models.scanner import Scanner
    from apm.parallel.multihost import count_multihost
    from apm.utils.config import ApmConfig

    maxhot = os.environ.get("APM_TEST_MAXHOT")
    if maxhot:
        import apm.ops.fused as fused

        fused.MAX_HOT = int(maxhot)

    rescan_calls = {"n": 0}
    _orig_fin = pipeline.finalize_filtration

    def _spy_fin(scanner, reader, plan, n, chunks, rescan, **kw):
        def _spy_rescan():
            rescan_calls["n"] += 1
            return rescan()

        return _orig_fin(scanner, reader, plan, n, chunks, _spy_rescan, **kw)

    pipeline.finalize_filtration = _spy_fin

    cfg = ApmConfig(backend="pallas", interpret=True, block_windows=1024)
    sc = Scanner(patterns, int(k), cfg)
    counts = count_multihost(sc, corpus_path)
    with open(out_json, "w") as f:
        json.dump(
            {
                "process": int(pid),
                "process_count": jax.process_count(),
                "counts": [int(c) for c in counts[: len(patterns)]],
                "rescan_calls": rescan_calls["n"],
            },
            f,
        )


if __name__ == "__main__":
    main()
