"""The run's guards: a process that holds JAX or the JAX package when the
window has closed prints no result and fails; the port, whose name starts
with the JAX package's, is not a hit; no card, no result."""

import json
import sys
import types

import pytest
import torch

from portbench import run


def test_forbidden_names_are_compared_whole():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "redner_tpu",
            "redner_tpu.render", "redner_torch.camera", "redner_tpu_torch",
            "redner_tpu_torch.render", "jaxtyping", "redner_tpu_extra"]
    assert run.forbidden_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "redner_tpu",
         "redner_tpu.render", "redner_torch.camera"])


def _fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr("portbench.yardstick.device_line", lambda: "card")
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: (
        {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
         "device": {}, "checks": {}}, [], {}))


ARGS = ["--workload", "pose.fwd512", "--seed", "2147483659", "--seconds",
        "1", "--trace", "0"]


@pytest.mark.parametrize("name,fails", [("jax", True), ("redner_tpu", True),
                                        ("redner_torch", True),
                                        ("redner_tpu_torch", False)])
def test_a_loaded_module_fails_the_run(monkeypatch, capsys, name, fails):
    _fake_card(monkeypatch)
    for m in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, sys.modules.get(
        name, types.ModuleType(name)))
    rc = run.main(ARGS)
    out, err = capsys.readouterr()
    if fails:
        assert rc != 0 and out == "" and name in err
    else:
        assert rc == 0 and json.loads(out.splitlines()[-1])["correct"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""
