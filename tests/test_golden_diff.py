"""Byte-diff conformance against the COMPILED reference binary.

The reference's own harness is compile-and-diff (``scripts/run_tests:27-45``);
round 1's parity rested on the hand-transcribed oracle. Here the actual
``apm_sequential`` (``src/sequential.c`` + ``src/utils.c``, gcc only — no
MPI, reference ``Makefile:31-32``) is built in a tmpdir from the read-only
reference tree and its stdout is diffed against ``python -m apm`` on the
``dna/`` fixtures, minus the timing lines.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The reference project's checkout (its src/, include/ and dna/).
REF = os.environ.get("APM_REFERENCE_DIR", "")


@pytest.fixture(scope="module")
def seq_binary(tmp_path_factory):
    if not REF or not os.path.isdir(os.path.join(REF, "src")):
        pytest.skip("reference source tree not available")
    if shutil.which("gcc") is None:
        pytest.skip("gcc not available")
    d = tmp_path_factory.mktemp("refbuild")
    exe = str(d / "apm_sequential")
    cmd = [
        "gcc", "-O3", "-w", f"-I{REF}/include",
        f"{REF}/src/sequential.c", f"{REF}/src/utils.c",
        "-o", exe, "-lm",
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return exe


def _pattern(name: str) -> str:
    with open(os.path.join(REF, "dna", name), "rb") as f:
        return f.read().decode().strip()  # $(cat file) semantics


def _run(cmd, env=None):
    r = subprocess.run(
        cmd, capture_output=True, text=True, timeout=600, env=env, cwd=REPO
    )
    assert r.returncode == 0, (cmd, r.stdout, r.stderr)
    return [
        l for l in r.stdout.splitlines() if not l.startswith("APM done in ")
    ]


CASES = [
    ("easy.fa", 0, ["123", "456", "78934"]),
    ("easy.fa", 1, ["123", "456", "78934"]),
    ("small_chrY.fa", 2, [_p for _p in ["line_10.fa", "line_20.fa"]]),
    (
        "small_chrY_x100.fa",
        0,
        ["line_10.fa", "line_20.fa", "line_non_existent.fa"],
    ),
    ("small_chrY_x100.fa", 1, ["line_20783.fa"]),
    ("small_chrY_medium.fa", 2, ["line_1131.fa"]),
]


@pytest.mark.parametrize("corpus,k,pats", CASES)
def test_sequential_binary_diff(seq_binary, dna_dir, corpus, k, pats):
    corpus_path = os.path.join(dna_dir, corpus)
    args = [_pattern(p) if p.endswith(".fa") else p for p in pats]
    want = _run([seq_binary, str(k), corpus_path, *args])

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    got = _run(
        [sys.executable, "-m", "apm", str(k), corpus_path, *args], env=env
    )
    assert got == want
