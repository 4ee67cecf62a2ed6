"""Twin of `tests/test_adversary.py`'s attack-matrix driver smoke
(`test_attack_matrix_driver_smoke`, :636) on the port:
`eval/eval_attack_matrix.py`'s `main` against the port's
`biscotti_tpu_torch.eval.eval_attack_matrix.main`, each over live
clusters of its own package's peers (`runtime/adversary.py`'s campaigns,
the defenses, `tools/verdicts.py`).

Both drivers run one argv (the port's with `--platform cpu`), and the
reference test's assertions are made on the port's artifact. The two
artifacts are held to what no timing decides: each row's campaign,
defense and secure-aggregation cell, whether it survived and how many
poisoned records it accepted. The port's peers draw their own batches
(the CLI builds them), so final errors are not compared.

One cell (static x KRUM) runs in tier-1; the reference's matrix, {static,
hug} x {NONE, KRUM}, is `slow`, as its reference. Ports are 23000-23199,
which no other test file uses."""

import importlib.util
import json
import os
import pathlib

import pytest

from biscotti_tpu_torch.eval import eval_attack_matrix as port_am

pytestmark = pytest.mark.campaign

ROOT = pathlib.Path(__file__).resolve().parent.parent
COLUMNS = {"campaign", "defense", "secure_agg", "final_error", "chains_equal",
           "survived", "failed", "verdict", "replay"}


def _reference_driver():
    spec = importlib.util.spec_from_file_location(
        "eval_attack_matrix", ROOT / "eval" / "eval_attack_matrix.py")
    am = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(am)
    return am


def _artifact(main, argv, out, extra=()):
    """`main(argv)` with its artifacts under `out`, the reference test's
    assertions on them; returns the rows."""
    rc = main(argv + ["--out", str(out), "--tag", "am_smoke", *extra])
    assert rc == 0
    art = json.loads((out / "am_smoke.json").read_text())
    for row in art["rows"]:
        assert COLUMNS <= set(row)
        assert row["failed"] == (0 if row["survived"] else 1)
        assert "tools.chaos" in row["replay"]
        if row["campaign"] != "none" and row["survived"]:
            assert row["verdict"]["n_accepted_poisoned"] == 0
    assert (out / "am_smoke.csv").exists()
    return art["rows"]


def _outcome(rows):
    return sorted((r["campaign"], r["defense"], r["secure_agg"],
                   r["survived"], r["verdict"]["n_accepted_poisoned"])
                  for r in rows)


def _twin(tmp_path, argv, port, cells):
    """The reference's driver, then the port's, on `argv` from `port`;
    each cell takes the next block of nodes + 2 ports."""
    ref_out, port_out = tmp_path / "reference", tmp_path / "port"
    for d in (ref_out, port_out):
        os.makedirs(d)
    step = (int(argv[argv.index("--nodes") + 1]) + 2) * cells
    ref = _artifact(_reference_driver().main,
                    argv + ["--base-port", str(port)], ref_out)
    got = _artifact(port_am.main, argv + ["--base-port", str(port + step)],
                    port_out, ("--platform", "cpu"))
    assert len(ref) == len(got) == cells
    assert _outcome(got) == _outcome(ref)


def test_attack_matrix_one_cell(tmp_path):
    """One cell of the reference's matrix, static x KRUM, at its width."""
    _twin(tmp_path, ["--quick", "--dataset", "creditcard", "--nodes", "5",
                     "--rounds", "3", "--campaigns", "static", "--defenses",
                     "KRUM"], 23000, 1)


@pytest.mark.slow
def test_attack_matrix_driver_smoke(tmp_path):
    _twin(tmp_path, ["--quick", "--dataset", "creditcard", "--nodes", "5",
                     "--rounds", "3", "--campaigns", "static,hug",
                     "--defenses", "NONE,KRUM"], 23020, 4)
