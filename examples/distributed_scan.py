#!/usr/bin/env python
"""Multi-device / multi-host scan example.

Single host with several GPUs: the Scanner shards the window axis over
every visible device automatically (strategy "database_over_devices").
Multi-host (one process per host; jax autodetects SLURM / Open MPI
clusters, elsewhere pass the coordinator to ``multihost.initialize``):

    # on every host:
    python examples/distributed_scan.py /path/to/corpus.fa

Each host stages only the byte ranges its own devices scan — no host ever
materializes the whole corpus. Simulate multiple devices anywhere with:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/distributed_scan.py
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import numpy as np

import apm
from apm.parallel import multihost
from apm.utils.config import ApmConfig


def main() -> int:
    if len(sys.argv) > 1:
        path = sys.argv[1]
    else:  # a seeded reference-shaped corpus
        from apm.utils.corpus import reference_shaped

        path = "distributed_scan_demo.fa"
        np.asarray(reference_shaped(1 << 20, seed=0)[0]).tofile(path)
    multihost.initialize()  # no-op single-process
    patterns = [b"GATTACA" * 3, b"CATCATCAT"]
    scanner = apm.Scanner(patterns, k=1, config=ApmConfig())
    counts = multihost.count_multihost(scanner, path)
    if jax.process_index() == 0:  # host 0 prints (rank-0 analog)
        print(f"devices={jax.device_count()} processes={jax.process_count()}")
        for p, c in zip(patterns, counts):
            print(f"Number of matches for pattern <{p.decode()}>: {int(c)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
