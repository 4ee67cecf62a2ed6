"""Whole runs of each cell at N = 16 on the CPU, the card's look
skipped: the program passes the comparison, the reference computed in
TF32 in its place fails it, and so does the program with each fault that
a cell of this kind can have planted under the timed path. The limits
are those set at this size (small_limits.json); the card's readings at
N = 1,024 are calibrate.py's. One test repeats the small run on a card
where there is one."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import calibrate, cells, harness  # noqa: E402
from benchmark.check import Judge, Rows, verdict  # noqa: E402

CELLS = ["mnist_cnn_n1024.krum_dp", "lfw_cnn_n1024.krum",
         "mnist_cnn_n1024.trimmed_mean_dp", "mnist_cnn_n1024.foolsgold_dp"]
SEED = 3_000_000_037


SMALL_LIMITS = json.loads((Path(__file__).parent / "small_limits.json")
                          .read_text())


def small(name: str) -> cells.Cell:
    """The cell at N = 16, held to the limits set at that size."""
    cell = cells.load(name, num_nodes=16, reference_block=8)
    cell.limits = SMALL_LIMITS[name]
    return cell


def run(cell, device="cpu", hook=None, seed=SEED):
    return harness.run(cell, seed, 0.05, False, device, 0.0, [],
                       build_hook=hook, log=lambda m: None)


@pytest.mark.parametrize("name", CELLS)
def test_the_program_agrees_with_the_reference(name):
    out = run(small(name))
    assert out["correct"], out["numbers"]


@pytest.mark.parametrize("name", ["mnist_cnn_n1024.krum_dp",
                                  "lfw_cnn_n1024.krum"])
def test_the_control_in_tf32_fails(name):
    cell = small(name)
    rows = Rows(cell, range(cell.settings["num_nodes"]))
    obs = calibrate.control_observed(cell, SEED, "cpu", rows)
    numbers = Judge(cell, SEED, "cpu", rows=rows).numbers(obs)
    assert not verdict(numbers, cell.limits), numbers


@pytest.mark.parametrize("fault", sorted(calibrate.FAULTS))
@pytest.mark.parametrize("name", ["mnist_cnn_n1024.krum_dp",
                                  "mnist_cnn_n1024.trimmed_mean_dp"])
def test_a_planted_fault_fails(name, fault):
    """Each of a training cell's faults, planted in the program under the
    timed path; one chip has no exchange between chips to leave out."""
    cell = small(name)
    holder = {}

    def hook(sim):
        holder["ctx"] = calibrate.FAULTS[fault](sim, SEED)
        holder["ctx"].__enter__()

    try:
        out = run(cell, hook=hook)
    finally:
        holder["ctx"].__exit__(None, None, None)
    assert not out["correct"], out["numbers"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_on_the_card_the_program_agrees(card, name):
    out = run(small(name), device=card)
    assert out["correct"], out["numbers"]
