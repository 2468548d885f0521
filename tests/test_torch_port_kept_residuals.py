"""The forward graph's kept autograd residuals (graphs.KeptProgram and
render_grad._kept_grads), on the CPU: single_triangle at 16x16, 2 spp,
one thread, seed 7, the gradients of sum(image * weight) w.r.t. the
diffuse, the light's intensity, every shape's vertices and the camera
position.

  * The backward body on kept residuals gives the re-render body's
    gradients bit for bit, with both edge samplers off and with primary
    edges only, at 1 and 2 bounces.
  * The graphed route, with graphs._Graph replaced by a fake whose
    capture runs no backward and whose replays run the bodies (so a
    forward replay builds a new tape, as a card's replay refreshes the
    captured one): an eligible key serves every backward from kept
    residuals (graphs.BACKWARDS["kept"]) and gives the eager route's
    image and gradients bit for bit, through its eager first call, its
    capture, its replays and a released pair's capture again; each
    ineligible key (decorrelated, a backward sample count of its own,
    secondary edges, remat) renders again ("ineligible"); two forwards of
    one key before one backward fall back ("overwritten"), and so does a
    second backward of one call; a backward that records runs eagerly
    ("create_graph").  The graphs themselves are card tests
    (tests/test_torch_port_cuda.py)."""

import numpy as np
import pytest
import torch

import redner_tpu_torch as rtt
from redner_tpu_torch import graphs, render_grad
from redner_tpu_torch.render import graph_forward
from redner_tpu_torch.scene import scene_tensors, scene_with_tensors
from tests.torch_port_spawn import single_triangle, with_grad_leaves
from tests.torch_port_util import one_thread, two_torch_threads  # noqa: F401

SEED = 7
RES = (16, 16)
NO_EDGES = dict(use_primary_edge_sampling=False,
                use_secondary_edge_sampling=False)
PRIMARY = dict(use_primary_edge_sampling=True,
               use_secondary_edge_sampling=False)


def _opts(**kw):
    return rtt.RenderOptions(**{"num_samples": 2, "max_bounces": 1, **kw})


def _weight():
    return torch.as_tensor(np.random.default_rng(0).uniform(
        0.5, 1.5, RES + (3,)).astype(np.float32))


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)


@pytest.mark.parametrize("bounces", [1, 2])
@pytest.mark.parametrize("edges", [NO_EDGES, PRIMARY],
                         ids=["no_edges", "primary"])
def test_kept_body_equals_rerender_body(edges, bounces,
                                        one_thread):  # noqa: F811
    scene = single_triangle(RES)
    with_grad_leaves(scene)
    opts = _opts(max_bounces=bounces, **edges)
    tensors = scene_tensors(scene)
    needs = [t.requires_grad for t in tensors]
    seed = torch.tensor(SEED, dtype=torch.int64)
    leaves = [t.detach().requires_grad_(n) for t, n in zip(tensors, needs)]
    fwd = scene_with_tensors(scene, leaves)
    img = graph_forward(opts, grad=True)(fwd, seed)
    with torch.no_grad():  # as autograd runs a first-order backward
        kept = render_grad._kept_grads(img, fwd, needs, opts, seed, None,
                                       _weight())
        again = render_grad._scene_grads(scene, tensors, needs, opts, seed,
                                         True, None, None, _weight())
    assert sum(g is not None for g in kept) == 5
    _same(kept, again)


class _FakeGraph:
    """A captured graph on the CPU: the capture runs a forward's body once
    for its static image (a backward's capture must not walk the tape);
    each replay runs the body."""

    def __init__(self, kind, body, device, pool=None):
        self.kind, self.body, self.bytes = kind, body, 0
        self.out = body() if kind == "forward" else None
        graphs.CAPTURES[kind] += 1

    def pool(self):
        return None

    def replay(self):
        self.out = self.body()
        graphs.REPLAYS[self.kind] += 1


@pytest.fixture
def fake_card(monkeypatch, one_thread):  # noqa: F811
    monkeypatch.setattr(graphs, "_Graph", _FakeGraph)
    monkeypatch.setattr(graphs, "_measured", lambda body, device: (body(),
                                                                    1))
    monkeypatch.setattr(graphs, "_device_free",
                        lambda device, need=None: 1 << 40)
    monkeypatch.setattr(graphs, "replays", lambda device, sharding=None: (
        not graphs._disabled))
    graphs.clear()
    yield
    graphs.clear()
    render_grad.set_use_correlated_random_number(True)


def _grads(entry, scene, opts, seeds, create_graph=False):
    """(images, gradients of the summed weighted images) of one pass over
    the renders of `scene` at each seed."""
    leaves = with_grad_leaves(scene)
    imgs = [entry(scene, opts, seed=s) for s in seeds]
    total = sum(torch.sum(img * _weight()) for img in imgs)
    grads = torch.autograd.grad(total, leaves, create_graph=create_graph)
    return [i.detach() for i in imgs], [g.detach() for g in grads]


def _eager(entry, scene, opts, seeds):
    with graphs.disable():
        return _grads(entry, scene, opts, seeds)


def _counts(before):
    return {k: v - before[k] for k, v in graphs.BACKWARDS.items() if v
            != before[k]}


def _program():
    (prog,) = graphs._cache.values()
    return prog


@pytest.mark.parametrize("entry,edges", [
    (rtt.render, NO_EDGES), (rtt.render, PRIMARY),
    (rtt.render_image, PRIMARY)], ids=["render", "render_primary",
                                       "render_image"])
def test_an_eligible_key_keeps_its_residuals(fake_card, entry, edges):
    """Steps 1-3 (eager, capture, replay), then a step after the pair was
    released: every backward kept, each step the eager route's bit for
    bit."""
    scene, opts = single_triangle(RES), _opts(**edges)
    before = dict(graphs.BACKWARDS)
    for step in range(4):
        if step == 3:
            assert _program().release() == 2
        got = _grads(entry, scene, opts, [SEED + step])
        want = _eager(entry, scene, opts, [SEED + step])
        _same(got[0], want[0])
        _same(got[1], want[1])
    assert isinstance(_program(), graphs.KeptProgram)
    assert _counts(before) == {"kept": 4}
    assert graphs.CAPTURES["backward"] >= 2


@pytest.mark.parametrize("setting", ["decorrelated", "num_samples_backward",
                                     "secondary", "remat"])
def test_an_ineligible_key_renders_again(fake_card, setting):
    scene = single_triangle(RES)
    opts = {"decorrelated": _opts(**NO_EDGES),
            "num_samples_backward": _opts(num_samples=(2, 1), **NO_EDGES),
            "secondary": _opts(use_secondary_edge_sampling=True,
                               use_primary_edge_sampling=False),
            "remat": _opts(remat=True, **NO_EDGES)}[setting]
    if setting == "decorrelated":
        render_grad.set_use_correlated_random_number(False)
    before = dict(graphs.BACKWARDS)
    _grads(rtt.render, scene, opts, [SEED])  # eager; the next captures
    got = _grads(rtt.render, scene, opts, [SEED + 1])
    _same(got[1], _eager(rtt.render, scene, opts, [SEED + 1])[1])
    assert not isinstance(_program(), graphs.KeptProgram)
    assert _counts(before) == {"ineligible": 2}


def test_two_forwards_before_one_backward_fall_back(fake_card):
    """Two views of one key a pass.  The first pass keeps both: the first
    view's eager tape, and the second's forward graph, captured alone (no
    backward measured yet) and walked eagerly with its tape kept for the
    backward's capture at the next pass.  Later passes: the later view is
    kept, the earlier's residuals were overwritten, so it renders again
    from its own tensors (the fallback, eager at its first need and
    captured at its second).  Every pass the eager route's gradients bit
    for bit."""
    scene, opts = single_triangle(RES), _opts(**NO_EDGES)
    before = dict(graphs.BACKWARDS)
    got = _grads(rtt.render, scene, opts, [SEED, SEED + 1])
    _same(got[1], _eager(rtt.render, scene, opts, [SEED, SEED + 1])[1])
    assert _counts(before) == {"kept": 2}
    before = dict(graphs.BACKWARDS)
    for step in range(3):
        seeds = [SEED + 2 * step, SEED + 2 * step + 1]
        got = _grads(rtt.render, scene, opts, seeds)
        want = _eager(rtt.render, scene, opts, seeds)
        _same(got[0], want[0])
        _same(got[1], want[1])
    assert _counts(before) == {"kept": 3, "overwritten": 3}
    assert _program().fallback.graphs["backward"] is not None


def test_a_second_backward_of_one_call_renders_again(fake_card):
    """A call's residuals serve one backward (the backward graph's
    gradients reuse the forward's blocks): a second backward of the same
    image, as loss.backward(retain_graph=True) twice, falls back and
    gives the same gradients."""
    scene, opts = single_triangle(RES), _opts(**NO_EDGES)
    leaves = with_grad_leaves(scene)
    for step in range(3):
        before = dict(graphs.BACKWARDS)
        loss = torch.sum(rtt.render(scene, opts, seed=SEED) * _weight())
        first = torch.autograd.grad(loss, leaves, retain_graph=True)
        second = torch.autograd.grad(loss, leaves)
        _same(first, second)
        assert _counts(before) == {"kept": 1, "overwritten": 1}


def test_a_backward_that_records_runs_eagerly(fake_card):
    scene, opts = single_triangle(RES), _opts(**NO_EDGES)
    _grads(rtt.render, scene, opts, [SEED])
    before = dict(graphs.BACKWARDS)
    _, grads = _grads(rtt.render, scene, opts, [SEED + 1], create_graph=True)
    assert _counts(before) == {"create_graph": 1}
    assert all(torch.isfinite(g).all() for g in grads)
