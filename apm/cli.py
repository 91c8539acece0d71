"""CLI driver mirroring the reference binaries' usage and output.

Usage (identical to ``apm_sequential`` / ``apm_parallel``,
``src/sequential.c:35-47`` and ``src/main.c:66-85``)::

    python -m apm <approx_factor> <dna_database> <pattern1> [pattern2 ...]
                  [PATTERNS_OVER_RANKS | DB_OVER_RANKS] [--flag ...]

Output format is byte-compatible with the reference (the observable API its
diff-based tests rely on, SURVEY.md §5):

* banner — ``sequential.c:79-82`` (typo "Mathing" included, for diff parity);
* ``APM done in %lf s`` — ``sequential.c:151``;
* ``Number of matches for pattern <%s>: %d`` — ``sequential.c:157-160``
  (pattern echoed verbatim; when a trailing strategy word selects the
  parallel variant, the echo is truncated to 100 chars by default like
  the reference parallel binary's ``%.100s`` — ``patterns_over_ranks.c:229``
  — overridable with ``--[no-]truncate-echo``).

The trailing strategy word maps the reference's explicit strategy override
(``main.c:75-85``) onto the device-mesh strategies: ``DB_OVER_RANKS`` →
``database_over_devices``, ``PATTERNS_OVER_RANKS`` → ``patterns_over_devices``.
Flags (``--backend``, ``--interpret`` …) replace the reference's compile-time
``-D`` config tier.
"""

from __future__ import annotations

import sys
from typing import List, Optional

# NB: jax-importing modules are imported lazily inside main() so that
# usage errors and --help paths don't pay the runtime-startup cost.

_STRATEGY_WORDS = {
    "DB_OVER_RANKS": "database_over_devices",
    "PATTERNS_OVER_RANKS": "patterns_over_devices",
    "DATABASE_OVER_DEVICES": "database_over_devices",
    "PATTERNS_OVER_DEVICES": "patterns_over_devices",
    "SINGLE": "single",
}


def _usage(prog: str) -> str:
    return (
        f"Usage: {prog} approximation_factor "
        "dna_database pattern1 pattern2 ...\n"
    )


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    prog = "apm"

    if len(argv) < 3:
        sys.stdout.write(_usage(prog))
        return 1

    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from .utils.config import ApmConfig

    # config-flag tier (replaces the reference's -D compile-time flags)
    cfg = ApmConfig()
    truncate_echo: Optional[bool] = None  # None = variant default
    positions = False
    rest: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--backend" and i + 1 < len(argv):
            cfg.backend = argv[i + 1]
            i += 2
        elif a.startswith("--backend="):
            cfg.backend = a.split("=", 1)[1]
            i += 1
        elif a == "--devices" and i + 1 < len(argv):
            cfg.max_devices = int(argv[i + 1])
            i += 2
        elif a.startswith("--devices="):
            cfg.max_devices = int(a.split("=", 1)[1])
            i += 1
        elif a == "--block-windows" and i + 1 < len(argv):
            cfg.block_windows = int(argv[i + 1])
            i += 2
        elif a.startswith("--block-windows="):
            cfg.block_windows = int(a.split("=", 1)[1])
            i += 1
        elif a == "--engine" and i + 1 < len(argv):
            cfg.engine = argv[i + 1]
            i += 2
        elif a.startswith("--engine="):
            cfg.engine = a.split("=", 1)[1]
            i += 1
        elif a == "--interpret":
            cfg.interpret = True
            i += 1
        elif a == "--verbose":
            cfg.verbose = True
            i += 1
        elif a == "--truncate-echo":
            truncate_echo = True
            i += 1
        elif a == "--no-truncate-echo":
            truncate_echo = False
            i += 1
        elif a == "--positions":
            positions = True
            i += 1
        else:
            rest.append(a)
            i += 1

    # trailing strategy word (main.c:66-85: only meaningful as the LAST arg,
    # and only when at least one pattern remains before it)
    if len(rest) >= 4 and rest[-1].upper() in _STRATEGY_WORDS:
        cfg.strategy = _STRATEGY_WORDS[rest[-1].upper()]
        rest = rest[:-1]
        # The reference's PARALLEL binary truncates the pattern echo to 100
        # chars unconditionally (%.100s, patterns_over_ranks.c:229); the
        # sequential one echoes verbatim (sequential.c:157-160). Mirror the
        # variant being invoked; --[no-]truncate-echo overrides.
        if truncate_echo is None:
            truncate_echo = True

    if len(rest) < 3:
        sys.stdout.write(_usage(prog))
        return 1

    try:
        approx_factor = int(rest[0])
    except ValueError:
        sys.stderr.write(f"Error while parsing argument 1\n")
        return 1
    filename = rest[1]
    patterns = [p.encode("latin-1") for p in rest[2:]]
    for idx, p in enumerate(patterns):
        if len(p) == 0:
            # sequential.c:65-68: zero-length pattern is a parse error
            sys.stderr.write(f"Error while parsing argument {idx + 3}\n")
            return 1

    sys.stdout.write(
        "Approximate Pattern Mathing: "
        f"looking for {len(patterns)} pattern(s) in file {filename} "
        f"w/ distance of {approx_factor}\n"
    )

    from .utils.io import read_input_file

    try:
        buf = read_input_file(filename)
    except (OSError, FileNotFoundError):
        sys.stderr.write(f"Unable to open the file {filename}\n")
        return 1

    from .models.scanner import Scanner

    scanner = Scanner(patterns, approx_factor, cfg)
    counts = scanner.count(buf)

    sys.stdout.write(f"APM done in {scanner.last_duration:.6f} s\n")
    for p, c in zip(patterns, counts):
        echo = p[:100] if truncate_echo else p
        sys.stdout.write(
            f"Number of matches for pattern <{echo.decode('latin-1')}>: {int(c)}\n"
        )
    if positions:
        # beyond the reference: exact window starts per pattern
        for p, pos in zip(patterns, scanner.find(buf)):
            echo = (p[:100] if truncate_echo else p).decode("latin-1")
            sys.stdout.write(
                f"Match positions for pattern <{echo}>:"
                + "".join(f" {int(j)}" for j in pos)
                + "\n"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
