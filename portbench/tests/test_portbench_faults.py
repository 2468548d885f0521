"""Each fault a cell can have, planted under the harness, turns `correct`
false; the sound run is correct.  The control (the reference with its
ray-triangle products rounded to TF32) fails too.  On the CPU no graph
replays, so the stale replay is planted at the entry point (a render of
the second call's inputs from the third call on)."""

import pytest
import torch

import redner_tpu_torch as rtt
from portbench import control
from portbench.tests.tiny import run_cpu, tiny_root

CELLS = {"pose.grad256_noedge": "grad", "pose.fwd512": "frame"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(root, cell):
    assert run_cpu(root, cell)["correct"] is True


@pytest.mark.parametrize("fault", control.FAULTS)
@pytest.mark.parametrize("cell", sorted(CELLS))
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
    import json

    limits = json.loads((root / "portbench/limits" / f"{cell}.json")
                        .read_text())
    numbers = control.readings(root, cell, 2147483659, "control", 0.5,
                               device="cpu")
    assert any(numbers[k] > lim for k, lim in limits.items())
