"""The reader of kept_share.grad on the port's graphs.BACKWARDS: the share
of backwards served from kept residuals, None in a frame cell, before any
backward, and from a port without the counter."""

from types import SimpleNamespace

import pytest

from portbench.run import load_reader
from portbench.tests.tiny import REPO
from redner_tpu_torch import graphs

GRAD = SimpleNamespace(kind="grad")


def test_share_of_kept_backwards(monkeypatch):
    read = load_reader(REPO, "kept_share.grad")
    monkeypatch.setattr(graphs, "BACKWARDS", {
        "kept": 6, "ineligible": 1, "overwritten": 1, "create_graph": 0})
    assert read(GRAD) == pytest.approx(75.0)
    assert read(SimpleNamespace(kind="frame")) is None
    monkeypatch.setattr(graphs, "BACKWARDS", dict.fromkeys(
        graphs.BACKWARDS, 0))
    assert read(GRAD) is None


def test_a_port_without_the_counter_gives_none(monkeypatch):
    monkeypatch.delattr(graphs, "BACKWARDS")
    assert load_reader(REPO, "kept_share.grad")(GRAD) is None
