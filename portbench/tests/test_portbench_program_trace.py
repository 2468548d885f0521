"""The readers of the port's own records (portbench/program_trace.py and
the per-layer metrics that read it), on synthetic contexts: each reader's
number, None from a port without tracing or a run without a card, and the
naming of idle gaps."""

from types import SimpleNamespace

import pytest

from portbench import program_trace as pt
from portbench.run import load_reader
from portbench.tests.tiny import REPO
from redner_tpu_torch.timing import Span

PROGRAM = {
    "calls": 3,
    "device_ms": {"fwd": 20.0, "bwd": 400.0, "rerender": 30.0,
                  "autograd": 360.0, "bwd:shade.surface": 300.0,
                  "autograd.other": 20.0, "isect.closest": 12.0,
                  "isect.any": 4.0, "kernel.closest_hit": 9.0,
                  "shade.surface": 6.0, "shade.nee": 3.0,
                  "shade.bsdf": 2.5, "camera": 1.0},
    "graph_ms": {}, "host_ms": {}, "cache_host_ms": 0.75,
    "pairs": 1234.0, "work": {}, "busy_ms": 430.0, "body_share": 0.98,
    "gather_bwd_ms": 350.0, "gaps": [],
}

EXPECTED = {
    "rerender_ms.grad": ("grad", 30.0),
    "autograd_ms.grad": ("grad", 360.0),
    "surface_bwd_ms.grad": ("grad", 300.0),
    "isect_ms.grad": ("grad", 16.0),
    "isect_pairs.grad": ("grad", 1234.0),
    "cache_host_ms.grad": ("grad", 0.75),
    "shade_ms.frame": ("frame", 11.5),
    "isect_ms.frame": ("frame", 16.0),
    "cache_host_ms.frame": ("frame", 0.75),
    "first_run_s": ("grad", 12.5),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_on_a_synthetic_context(name):
    """Each reader's number from a context the program trace filled, None
    in the other kind's cells and where the stretch gave nothing."""
    kind, want = EXPECTED[name]
    read = load_reader(REPO, name)
    ctx = SimpleNamespace(kind=kind, program=PROGRAM, first_run_s=12.5)
    assert read(ctx) == pytest.approx(want)
    other = "frame" if kind == "grad" else "grad"
    if name != "first_run_s":
        assert read(SimpleNamespace(kind=other, program=PROGRAM)) is None
    assert read(SimpleNamespace(kind=kind, program=None,
                                first_run_s=None)) is None


def test_no_card_no_program():
    """A run without a card's profile (the CPU harness) reads nothing and
    runs no stretch."""
    ctx = SimpleNamespace(kind="grad", profile=None)
    assert pt.context(ctx) is None
    assert ctx.program is None and ctx.first_run_s is None
    for name in EXPECTED:
        assert load_reader(REPO, name)(ctx) is None


def test_a_port_without_tracing_gives_none():
    """The parent's port has no timing.set_tracing: program_stretch runs
    nothing of the loop and returns None."""
    loop = SimpleNamespace(step=lambda k: pytest.fail("stepped"), next_k=0)
    for port in (SimpleNamespace(),
                 SimpleNamespace(timing=SimpleNamespace(timed=None))):
        assert pt.program_stretch(port, loop, 3, None, "cuda") is None


def _span(name, a, b, sid, parent=None):
    return Span(1, sid, parent, name, a, b, {})


def test_gaps_take_the_innermost_program_span_else_the_harness():
    """A gap is named by the shortest program span that covers more than
    half of it; else by the harness span that overlaps it most."""
    recs = [_span("render", 0.0, 10.0, 1), _span("cache.copy", 4.0, 5.0, 2, 1),
            _span("cache.replay", 2.0, 3.0, 3, 1),
            Span(1, 4, 3, "fwd", None, None, {}, 0.02)]  # no host time
    harness = [("render", 0.0, 10.0), ("loss_read", 10.0, 12.0)]
    gaps = [(4.1, 4.9),    # inside cache.copy (and render)
            (2.9, 3.6),    # 1/7 in cache.replay: render covers it
            (10.5, 11.5),  # no program span: the harness's loss_read
            (20.0, 20.5)]  # nothing: "harness"
    named = pt.name_gaps(gaps, recs, harness)
    assert named == [["loss_read", pytest.approx(1.0)],
                     ["cache.copy", pytest.approx(0.8)],
                     ["render", pytest.approx(0.7)],
                     ["harness", pytest.approx(0.5)]]


def test_summarise_splits_a_stretch_per_call():
    """Device ms by phase and by graph, the cache's outermost spans' host
    ms, the work and the busy time, per call; the spans' own annotations
    are not device operations."""
    recs = [_span("render", 0.0, 1.0, 1),
            _span("cache.replay", 0.1, 0.3, 2, 1),
            _span("cache.make_room", 0.15, 0.2, 3, 2),
            _span("cache.copy", 0.3, 0.4, 4, 1),
            Span(1, 5, 2, "fwd", None, None, {}, 0.5),
            Span(1, 6, 5, "isect.closest", None, None, {"graph": "fwd"},
                 0.1)]
    kern = [("k", 0.0, 0.5), ("indexing_backward_kernel", 0.5, 0.7),
            ("render", 0.0, 1.0)]
    p = pt.summarise(recs,
                     {"closest_hit": (10.0, 128.0), "any_hit": (2.0, 128.0)},
                     2, (kern, 0.0, 1.0, []), recs[:1])
    assert p["device_ms"] == pytest.approx({"fwd": 250.0,
                                            "isect.closest": 50.0})
    assert p["graph_ms"] == pytest.approx({"fwd:isect.closest": 50.0})
    assert p["cache_host_ms"] == pytest.approx(150.0)
    assert p["pairs"] == 12.0
    assert p["busy_ms"] == pytest.approx(350.0)
    assert p["gather_bwd_ms"] == pytest.approx(100.0)
    assert p["body_share"] == pytest.approx(250.0 / 350.0)


@pytest.mark.parametrize("missing", ["make_loop", "profiled", "device"])
def test_a_stretch_without_its_cell_says_so(missing, capsys):
    """traced_run builds its loop with the run's own make_loop, over the
    run's profiled count on its device; where the context lacks one,
    context() prints why the stretch failed and reads nothing, and no
    loop is built."""
    ctx = SimpleNamespace(kind="grad", profile=[], profiled=3,
                          device="cpu",
                          make_loop=lambda spans: pytest.fail("built"))
    delattr(ctx, missing)
    assert pt.context(ctx) is None and ctx.program is None
    err = capsys.readouterr().err
    assert "the traced stretch failed" in err and missing in err


def test_report_prints_the_cache_counters(capsys):
    """The [program] lines name the graph cache's releases and emptyings
    over the stretch and since import."""
    pt.report(dict(PROGRAM, cache_counts={"released": (2, 5),
                                          "empty_cache": (3, 7)}))
    err = capsys.readouterr().err
    assert ("graph cache over the stretch (since import): graphs released "
            "2 (5), cache emptied 3 (7)") in err
    assert err.count("[program]") == len(err.strip().splitlines())
