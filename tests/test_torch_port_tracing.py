"""The port's tracing (redner_tpu_torch.timing) on the CPU: host spans of
an eager render, the backward phases of its autograd marks, the results
left bit for bit as they are, the device phases' bookkeeping on fake
events (a graph's replays, the split of autograd), timed, profile_trace
and the graph cache's key.  The card's side (events captured in graphs,
work counters that replays keep) is in tests/test_torch_port_cuda.py."""

import re

import pytest
import torch

import redner_tpu_torch as rtt
from redner_tpu_torch import graphs, timing
from redner_tpu_torch.ops import intersect_cuda as ic
from redner_tpu_torch.scene import scene_leaves, scene_with_leaves
from tests.torch_port_util import one_thread  # noqa: F401
from tests.torch_port_util import two_torch_threads  # noqa: F401


@pytest.fixture
def tracing():
    """Tracing on for one test, its records dropped before and after."""
    timing.clear()
    timing.set_tracing(True)
    yield
    timing.set_tracing(False)
    timing.clear()


def _scene():
    v, f, uv, n = rtt.generate_sphere(6, 12, device="cpu")
    cam = rtt.make_camera(position=[0.0, 1.5, -4.0], look_at=[0.0, 0.0, 0.0],
                          up=[0.0, 1.0, 0.0], fov=45.0, resolution=(8, 8),
                          device="cpu")
    mat = rtt.make_material(diffuse_reflectance=[0.5, 0.5, 0.5],
                            specular_reflectance=[0.2, 0.2, 0.2],
                            roughness=[0.05], device="cpu")
    floor = rtt.Object(vertices=[[-4.0, -1.0, -4.0], [4.0, -1.0, -4.0],
                                 [-4.0, -1.0, 4.0], [4.0, -1.0, 4.0]],
                       indices=[[0, 2, 1], [1, 2, 3]], material=mat)
    light = rtt.generate_quad_light([0.0, 3.0, -1.0], [0.0, 0.0, 0.0],
                                    [1.5, 1.5], [20.0, 20.0, 20.0],
                                    device="cpu")
    return rtt.scene_from_objects(cam, [
        rtt.Object(vertices=v, indices=f, uvs=uv, normals=n, material=mat),
        floor, light])


OPTS = rtt.RenderOptions(num_samples=2, max_bounces=2)


def _step(entry, traced):
    """One render of the scene with every float leaf a fresh leaf, and the
    backward of a weighted sum of it: (image, [leaf gradients])."""
    timing.set_tracing(traced)
    try:
        leaves = [x.detach().clone().requires_grad_(x.is_floating_point())
                  for x in scene_leaves(_scene())]
        img = entry(scene_with_leaves(_scene(), leaves), OPTS, seed=3)
        w = torch.linspace(0.5, 1.5, img.numel()).reshape(img.shape)
        (img * w).sum().backward()
    finally:
        timing.set_tracing(False)
    return img.detach(), [x.grad for x in leaves]


def _nodes(fn):
    """Every node of an autograd graph."""
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        todo.extend(g for g, _ in f.next_functions)
    return seen


def _self_seconds(s, spans):
    """A host span's seconds less its children's."""
    return s.seconds - sum(c.seconds for c in spans
                           if c.parent == s.id and c.seconds is not None)


def test_tracing_off_records_nothing():
    """With tracing off a render records no span, puts no mark in the
    autograd graph and makes no counter tensor."""
    timing.clear()
    scene = _scene()
    leaves = [x.detach().clone().requires_grad_(x.is_floating_point())
              for x in scene_leaves(scene)]
    img = rtt.render(scene_with_leaves(scene, leaves), OPTS, seed=0)
    names = {type(f).__name__ for f in _nodes(img.grad_fn)}
    assert not any("Exit" in n or "Enter" in n for n in names)
    img.sum().backward()
    assert timing.records() == []
    assert all(w["pairs"] == {} and w["lanes"] == w["captured"] == 0
               for w in ic.WORK.values())
    assert timing.span("x") is timing.phase("y", "cpu") is timing.timed("z")


def test_an_eager_render_records_its_span_tree(tracing):
    """render on the CPU: every record has the call's one id and a parent
    among the records (or none, the entry); the phases are there with
    their graph and bounce; children lie inside their parents, so a
    span's self time (its seconds less its children's) is not negative."""
    scene = _scene()
    leaves = [x.detach().clone().requires_grad_(x.is_floating_point())
              for x in scene_leaves(scene)]
    img = rtt.render(scene_with_leaves(scene, leaves), OPTS, seed=0)
    img.sum().backward()
    recs = timing.records()
    by_id = {r.id: r for r in recs}
    assert len({r.call for r in recs}) == 1
    roots = [r for r in recs if r.parent is None]
    assert sorted(r.name for r in roots) == ["render", "render.backward"]
    assert all(r.parent is None or r.parent in by_id for r in recs)
    names = {r.name for r in recs}
    assert {"fwd", "camera", "isect.closest", "isect.any", "shade.surface",
            "shade.nee", "shade.bsdf", "bwd", "rerender", "autograd",
            "reduce", "edge.primary", "edge.secondary", "bwd:camera",
            "bwd:shade.surface", "bwd:shade.nee",
            "bwd:shade.bsdf"} <= names
    bsdf = [r for r in recs if r.name == "shade.bsdf"]
    assert {r.attrs["bounce"] for r in bsdf} == {0, 1}
    assert {r.attrs["graph"] for r in bsdf} == {"fwd", "bwd"}
    for r in recs:
        assert r.device is None and r.seconds >= 0
        kids = [c for c in recs if c.parent == r.id]
        if r.name.startswith("bwd:"):
            assert by_id[r.parent].name == "autograd"
            continue
        for c in kids:
            if not c.name.startswith("bwd:"):
                assert r.start <= c.start <= c.end <= r.end
        assert _self_seconds(r, recs) >= 0


@pytest.mark.parametrize("entry", [rtt.render, rtt.render_image],
                         ids=["render", "render_image"])
def test_tracing_changes_no_result(one_thread, entry):  # noqa: F811
    """The image and every leaf's gradient, bit for bit, with tracing on
    and off: the marks neither change a value nor the order in which
    autograd sums a gradient."""
    img0, g0 = _step(entry, False)
    img1, g1 = _step(entry, True)
    timing.clear()
    assert torch.equal(img0, img1)
    assert sum(g is not None for g in g0) >= 5
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


class FakeEvent:
    """A timing event at a fixed device time (seconds)."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3

    def query(self):
        return True


def _rec(key, name, bounce):
    return timing._Rec(key, name, {"graph": "bwd", "bounce": bounce}, True, 1)


def _fake_batch():
    """A backward graph's body as a capture records it: bwd (0-10 s) holding
    rerender (0-3) and autograd (3-9), whose marks open shade.bsdf at 4,
    close it at 5, open shade.surface at 5 and close it at 8."""
    s = {i: timing.Span(1, i, p, n, 0.0, 1.0, {}) for i, p, n in
         ((100, None, "bwd"), (101, 100, "rerender"),
          (102, 100, "autograd"))}
    ev = {100: (0, 10), 101: (0, 3), 102: (3, 9)}
    b = timing._Batch()
    for sid in (101, 102, 100):
        b.phases.append((s[sid], FakeEvent(ev[sid][0]),
                         FakeEvent(ev[sid][1])))
    bs, su = _rec(7, "shade.bsdf", 0), _rec(8, "shade.surface", 0)
    for kind, rec, t in (("start", bs, 4), ("end", bs, 5),
                         ("start", su, 5), ("end", su, 8)):
        b.marks.append((kind, rec, FakeEvent(t), 0.0, 102))
    return b


def test_a_replay_reads_its_phases_and_splits_autograd(tracing):
    """A graph's replays, read: each gives new records of its call under
    the replaying span, with the whole body's `.other` and the autograd
    split whose parts add up to autograd."""
    trace = timing.GraphTrace()
    trace.batches.append(_fake_batch())

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    with timing.entry("render.backward", 41) as outer:
        trace.replay(Graph())
        trace.replay(Graph())  # reads the first replay
    recs = timing.records()
    assert Graph.replays == 2
    calls = {r.call for r in recs}
    assert calls == {outer.span.call}
    dev = [r for r in recs if r.device is not None]
    assert sorted(r.name for r in dev if r.name == "bwd") == ["bwd", "bwd"]
    one = {}
    for r in dev[:len(dev) // 2]:
        one[r.name] = one.get(r.name, 0.0) + r.device
    assert one == pytest.approx({
        "bwd": 10, "rerender": 3, "autograd": 6, "bwd.other": 1,
        "bwd:shade.bsdf": 1, "bwd:shade.surface": 3, "autograd.other": 2})
    first = dev[:len(dev) // 2]
    body = next(r for r in first if r.name == "bwd")
    assert body.parent == outer.span.id and body.start is None
    ag = next(r for r in first if r.name == "autograd")
    assert {r.parent for r in first if r.name.startswith(
        ("bwd:", "autograd."))} == {ag.id}
    assert next(r for r in first if r.name == "bwd:shade.bsdf"
                ).attrs["bounce"] == 0


def test_timed_prints_as_before_and_is_a_span(capsys, tracing):
    """timed prints `<label>: <ms> ms` with print timing on; with tracing
    on it is a span, printing nothing unless print timing is on."""
    with timing.timed("quiet"):
        pass
    assert capsys.readouterr().out == ""
    timing.set_print_timing(True)
    try:
        with timing.timed("loud"):
            pass
    finally:
        timing.set_print_timing(False)
    assert re.fullmatch(r"loud: \d+\.\d\d ms\n", capsys.readouterr().out)
    assert [r.name for r in timing.records()] == ["quiet", "loud"]
    timing.set_tracing(False)
    timing.set_print_timing(True)
    try:
        with timing.timed("plain"):
            pass
    finally:
        timing.set_print_timing(False)
    assert re.fullmatch(r"plain: \d+\.\d\d ms\n", capsys.readouterr().out)
    assert [r.name for r in timing.records()] == ["quiet", "loud"]


def test_profile_trace_turns_tracing_on(tmp_path):
    """Tracing is on inside profile_trace and as it was after; the spans
    inside are record_functions in the Chrome trace it writes."""
    timing.clear()
    assert not timing.get_tracing()
    with timing.profile_trace(str(tmp_path)):
        assert timing.get_tracing()
        with timing.span("operator.block"):
            torch.ones(4).sum()
    assert not timing.get_tracing()
    assert [r.name for r in timing.records()] == ["operator.block"]
    timing.clear()
    (trace,) = tmp_path.glob("trace_*.json")
    assert "operator.block" in trace.read_text()


def test_cache_key_holds_the_tracing_flag():
    """A graph captured with tracing on holds its phases' events, so the
    flag is part of the key; the mesh stays last."""
    scene = _scene()
    key = lambda: graphs.cache_key("render", scene, OPTS, True, None)  # noqa
    off = key()
    timing.set_tracing(True)
    try:
        on = key()
    finally:
        timing.set_tracing(False)
    assert off != on and off[:-2] == on[:-2] and off[-1] is on[-1] is None
    assert key() == off
