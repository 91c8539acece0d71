"""CLI output conformance — the analog of the reference's diff-based
``scripts/run_tests`` harness (output format IS the observable API).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(*args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "-m", "apm", *args],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=env,
        timeout=300,
    )


def out_lines_sans_timing(stdout: str):
    return [l for l in stdout.splitlines() if not l.startswith("APM done in ")]


@pytest.fixture(scope="module")
def easy(tmp_path_factory):
    """The reference's ``easy.fa`` (digits on one line)."""
    path = tmp_path_factory.mktemp("dna") / "easy.fa"
    path.write_bytes(b"123123123456456\n")
    return str(path)


def test_cli_easy_reference_format(easy):
    r = run_cli("0", easy, "123", "456", "78934", "--backend", "xla")
    assert r.returncode == 0, r.stderr
    lines = out_lines_sans_timing(r.stdout)
    assert lines == [
        "Approximate Pattern Mathing: "
        f"looking for 3 pattern(s) in file {easy} w/ distance of 0",
        "Number of matches for pattern <123>: 3",
        "Number of matches for pattern <456>: 2",
        "Number of matches for pattern <78934>: 0",
    ]
    assert any(l.startswith("APM done in ") and l.endswith(" s") for l in r.stdout.splitlines())


def test_cli_usage_error():
    r = run_cli("0")
    assert r.returncode == 1
    assert r.stdout.startswith("Usage: ")


def test_cli_missing_file():
    r = run_cli("0", "/nonexistent/db.fa", "ACGT")
    assert r.returncode == 1
    assert "Unable to open the file" in r.stderr


def test_cli_strategy_word_and_determinism(easy):
    """Explicit strategy override (main.c:75-85 analog) + run-to-run diff."""
    outs = []
    for _ in range(2):
        r = run_cli(
            "1", easy, "123", "999", "DB_OVER_RANKS", "--backend", "xla",
            "--devices", "2",
        )
        assert r.returncode == 0, r.stderr
        outs.append(out_lines_sans_timing(r.stdout))
    assert outs[0] == outs[1]  # the run_tests determinism check
    assert outs[0][1].startswith("Number of matches for pattern <123>: ")


def test_cli_positions_flag(easy):
    r = run_cli("0", easy, "123", "--backend", "xla", "--positions")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert "Number of matches for pattern <123>: 3" in lines
    assert "Match positions for pattern <123>: 0 3 6" in lines


def test_cli_parallel_variant_truncates_echo(easy):
    """The reference parallel binary echoes patterns via %.100s
    (patterns_over_ranks.c:229) unconditionally; the sequential one is
    verbatim. The strategy word selects the variant default."""
    long_pat = "1231231234" * 11  # 110 chars of corpus alphabet
    r = run_cli(
        "0", easy, "123", long_pat, "DB_OVER_RANKS", "--backend", "xla",
        "--devices", "2",
    )
    assert r.returncode == 0, r.stderr
    assert f"pattern <{long_pat[:100]}>:" in r.stdout
    assert long_pat not in r.stdout
    # sequential default: verbatim
    r2 = run_cli("0", easy, "123", long_pat, "--backend", "xla")
    assert f"pattern <{long_pat}>:" in r2.stdout
    # and the override restores verbatim echo in the parallel variant
    r3 = run_cli(
        "0", easy, "123", long_pat, "DB_OVER_RANKS", "--backend", "xla",
        "--devices", "2", "--no-truncate-echo",
    )
    assert f"pattern <{long_pat}>:" in r3.stdout


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result line without a
    GPU, and in a directory holding nothing of the repo but itself."""
    import shutil

    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, script], capture_output=True, text=True, cwd=cwd,
        env=env, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
