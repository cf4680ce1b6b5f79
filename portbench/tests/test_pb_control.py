"""The control fails each cell's limit: the cell's reference, put in the
program's place and computed in bfloat16 (the configurations state
float32), at a size a test run holds. On the card at the cells' own
sizes, portbench/control.py reads the same numbers (PERF.md)."""

import importlib
import os

import pytest
import torch

from conftest import GIF_CELL, PHOTO420, REPO
from portbench import control, harness

SEEDS = (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3)
CELLS = (PHOTO420, "thumb256_jpeg.phone12mp_o6", GIF_CELL)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(tiny_root, cell):
    c = harness.load_cell(cell, tiny_root)
    maker = importlib.import_module("portbench.inputs." + c.workload["maker"])
    limits = c.workload["check"]["limits"]
    for seed in SEEDS:
        inputs = maker.make(c.workload["inputs"], seed, "cpu")
        got = control.control_numbers(c, inputs, seed, "cpu", torch.bfloat16)
        assert any(got[k] > v for k, v in limits.items()), (seed, got)
        sound = control.control_numbers(c, inputs, seed, "cpu",
                                        torch.float64)
        assert all(sound[k] == 0 for k in limits), (seed, sound)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in harness._json(
    os.path.join(REPO, "BENCHMARK.json"))["workloads"]])
def test_control_fails_the_limit_at_the_cells_size(card, cell):
    c = harness.load_cell(cell)
    maker = importlib.import_module("portbench.inputs." + c.workload["maker"])
    limits = c.workload["check"]["limits"]
    inputs = maker.make(c.workload["inputs"], SEEDS[0], card)
    got = control.control_numbers(c, inputs, SEEDS[0], card, torch.bfloat16)
    assert any(got[k] > v for k, v in limits.items()), got
