"""apm — approximate pattern matching (Levenshtein scan) on an accelerator.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
INF560 MPI+OpenMP+CUDA reference: count, for each pattern, the text windows
whose Levenshtein distance to the pattern is <= k, with byte-for-byte count
parity against the sequential C semantics.
"""

__version__ = "0.2.0"

from .utils import ApmConfig, PatternSet, read_input_file
from .models.scanner import Scanner, scan_counts

__all__ = [
    "ApmConfig",
    "PatternSet",
    "Scanner",
    "scan_counts",
    "read_input_file",
    "__version__",
]
