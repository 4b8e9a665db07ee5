"""CLI end-to-end: file in -> file out, byte parity with the reference."""

import shutil
import subprocess
import sys

import pytest

from conftest import GOLDEN_INPUT
from psa.utils.cli import main
from psa.utils.generator import random_sequences, write_input_file


def test_cli_golden_roundtrip(tmp_path, golden_expected):
    out = tmp_path / "output.txt"
    rc = main([GOLDEN_INPUT, "-o", str(out),
               "--backend", "native", "--quiet"])
    assert rc == 0
    assert out.read_text() == golden_expected


def test_cli_generated_both_modes(tmp_path):
    seq1, seq2 = random_sequences(900, 200, seed=3)
    for mode in ("maximum", "minimum"):
        inp = tmp_path / f"in_{mode}.txt"
        out = tmp_path / f"out_{mode}.txt"
        write_input_file(str(inp), [1.0, 2.0, 3.0, 4.0], seq1, seq2, mode == "maximum")
        rc = main([str(inp), "-o", str(out), "--backend", "numpy", "--quiet"])
        assert rc == 0
        text = out.read_text()
        mutant, tail = text.split("\n")
        assert len(mutant) == len(seq2)
        off, score = tail.split()
        assert 0 <= int(off) <= len(seq1) - len(seq2)


def test_cli_no_mutation_end_to_end(tmp_path):
    """Digits-only sequences in lenient mode: every pair is out-of-range ->
    weight 0, no substitution anywhere -> the defined no-mutation behavior
    (reference UB, SURVEY.md Q3): message, unmodified seq2, offset -1, exit 1."""
    inp = tmp_path / "in.txt"
    inp.write_text("1 3 4 2\n111111\n2222\nminimum\n")
    out = tmp_path / "out.txt"
    rc = main([str(inp), "-o", str(out), "--backend", "numpy",
               "--lenient", "--quiet"])
    assert rc == 1
    assert out.read_text() == "2222\n-1 inf"


def test_cli_no_mutation_path(tmp_path):
    # A one-letter seq2 against identical seq1 chars in MAX mode yields a
    # mutation (identity is never offered for '*'), but weights can make every
    # substitution illegal only when no legal dot/space partner exists; use
    # 'C' (conservative only with CSA members) vs all-'C' seq1 in MAX mode:
    # sign '*', dot/space subs exist, so mutation IS found. True no-mutation
    # requires out-of-alphabet sequences — craft with hyphens-only seq2 in MAX
    # mode: '-' vs '-' is '*', dot candidates don't exist for '-', space subs
    # do (any letter), so still found. The practical no-mutation case is the
    # empty candidate table (num_ranks == 0), which cannot happen with A-Z
    # alphabets — assert the exception path via a degenerate direct call.
    import numpy as np

    from psa.core.result import NoMutationFound
    from psa.core.tables import build_tables
    from psa.ops.select import select_best

    t = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    counts = np.zeros((4, 4), np.int32)
    maxrank = np.full(4, -1, np.int32)
    with pytest.raises(NoMutationFound):
        select_best(counts, maxrank, t, np.zeros(10, np.int32), np.zeros(7, np.int32))


def test_cli_rejects_non_finite_weights(tmp_path, capsys):
    """inf/nan weight tokens are a defined parse error (exit 2), replacing
    the reference's fscanf-driven downstream UB."""
    inp = tmp_path / "in.txt"
    inp.write_text("1 inf 4 2\nABCD\nAB\nminimum\n")
    out = tmp_path / "out.txt"
    rc = main([str(inp), "-o", str(out), "--backend", "numpy", "--quiet"])
    assert rc == 2
    assert "finite" in capsys.readouterr().err
    assert not out.exists()


def test_cli_json_single(tmp_path, capsys, golden_expected):
    import json

    out = tmp_path / "output.txt"
    rc = main([GOLDEN_INPUT, "-o", str(out),
               "--backend", "native", "--json"])
    assert rc == 0
    obj = json.loads(capsys.readouterr().out.strip())
    assert obj["mutation_found"] is True
    assert obj["offset"] == 6132 and obj["score"] == -4688.0
    mutant_line = golden_expected.split("\n")[0]
    assert obj["mutant"] == mutant_line
    assert obj["time_s"] > 0
    # the output file is still the byte-exact reference format
    assert out.read_text() == golden_expected


def test_cli_json_no_mutation(tmp_path, capsys):
    import json

    inp = tmp_path / "in.txt"
    inp.write_text("1 3 4 2\n111111\n2222\nminimum\n")
    out = tmp_path / "out.txt"
    rc = main([str(inp), "-o", str(out), "--backend", "numpy",
               "--lenient", "--json"])
    assert rc == 1
    obj = json.loads(capsys.readouterr().out.strip())
    assert obj["mutation_found"] is False
    assert obj["offset"] == -1 and obj["score"] == "inf"
    assert obj["mutant"] == "2222"


def test_cli_json_batch(tmp_path, capsys):
    import json

    recs = []
    for s in range(3):
        seq1, seq2 = random_sequences(400, 90, seed=s)
        recs.append(f"1 3 4 2\n{seq1}\n{seq2}\nminimum")
    inp = tmp_path / "in.txt"
    inp.write_text("\n".join(recs))
    rc = main([str(inp), "--batch", "-o", str(tmp_path / "out"),
               "--backend", "native", "--json", "--quiet"])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 3
    for i, ln in enumerate(lines):
        obj = json.loads(ln)
        assert obj["case"] == i and obj["mutation_found"] is True
        # JSON result must agree with the written reference-format file
        body = (tmp_path / "out" / f"out_{i:04d}.txt").read_text()
        mutant, tail = body.split("\n")
        off, score = tail.split()
        assert obj["mutant"] == mutant and obj["offset"] == int(off)


def test_cli_explain_runs(tmp_path):
    seq1, seq2 = random_sequences(300, 80, seed=4)
    inp = tmp_path / "in.txt"
    write_input_file(str(inp), [1.0, 3.0, 4.0, 2.0], seq1, seq2, False)
    r = subprocess.run(
        [sys.executable, "-m", "psa.utils.cli", str(inp),
         "-o", str(tmp_path / "out.txt"),
         "--backend", "numpy", "--explain", "--print-table", "--quiet"],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert "Original Score:" in r.stdout and "Mutation Score:" in r.stdout
    assert "A |*" in r.stdout  # --print-table sign matrix
