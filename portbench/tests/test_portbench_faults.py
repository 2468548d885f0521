"""Each fault a cell can have (the edge faults where its traffic turns
the sampler on), planted under the harness, turns `correct` false; the
sound run is correct.  The control (the reference with its
ray-triangle products rounded to TF32) fails too.  On the CPU no graph
replays, so the stale replay is planted at the entry point (a render of
the second call's inputs from the third call on)."""

import json

import pytest
import torch

import redner_tpu_torch as rtt
from portbench import control
from portbench.tests.tiny import add_edge_cell, run_cpu, tiny_root

CELLS = {"pose.grad256_noedge": "grad", "pose.fwd512": "frame",
         "pose.grad32_primary": "grad"}
# Cells made in the test (tiny.add_edge_cell): the port's primary edges,
# whose faults the first gradient shows.
EDGE_CELLS = {"pose.grad32_primary": {"primary_edge": True,
                                      "secondary_edge": False}}
PAIRS = [(c, f) for c in sorted(CELLS) for f in control.FAULTS
         if control.applies(f, EDGE_CELLS.get(c, {}))]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("faults"))
    for name, samplers in EDGE_CELLS.items():
        add_edge_cell(root, name, **samplers)
    return root


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(root, cell):
    assert run_cpu(root, cell)["correct"] is True


@pytest.mark.parametrize("cell,fault", PAIRS)
def test_fault_is_not_correct(root, cell, fault):
    undo = control.plant(fault, rtt, torch, CELLS[cell], device="cpu")
    try:
        assert run_cpu(root, cell)["correct"] is False
    finally:
        undo()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(root, cell):
    """The reference with TF32 products in the port's place fails one of
    the cell's numbers, at the tiny size as at the cell's own on the
    card (PERF.md)."""
    limits = json.loads((root / "portbench/limits" / f"{cell}.json")
                        .read_text())
    numbers = control.readings(root, cell, 2147483659, "control", 0.5,
                               device="cpu")
    assert any(numbers[k] > lim for k, lim in limits.items())
