"""The control comes out not correct: on the card, the reference in TF32
in the program's place fails at least one of the cell's numbers, and so
does the training cell's planted fault (half of each batch left out).
Needs the card (``-m cuda``); at the cells' widths with a few inputs."""

import copy

import pytest
import torch

from pillarbench import control, judge
from pillarbench.cells import Cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return torch.device("cuda", 0)


def small(name: str, **traffic) -> Cell:
    cell = Cell(name)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic.update(traffic)
    return cell


def test_serving_control_fails(card):
    cell = small("offline.full", pool=4, compare=2)
    out = control.run(cell, [101, 102, 103], card)
    for seed, numbers in out.items():
        ok, checks = judge.verdict(numbers["control"], cell.traffic["limits"])
        assert not ok, (seed, checks)


def test_training_control_and_fault_fail(card):
    cell = small("train.full", pool=3, batch=2)
    out = control.run(cell, [104, 105, 106], card)
    for seed, numbers in out.items():
        for kind in ("control", "half_batch"):
            ok, checks = judge.verdict(numbers[kind], cell.traffic["limits"])
            assert not ok, (seed, kind, checks)
