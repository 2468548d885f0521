"""Remat on the port's edge-sampled backward (redner_tpu/render.py:1168),
the secondary-edge candidate draw over runs of lanes, and the
isect_replay_max_mb option, which the port accepts and which changes
nothing (the backward re-runs its ray queries; render_grad).

JAX's own replay and remat are held to its live path by
tests/test_isect_replay.py, so here the port's rematerialised path is held
to the port's live one.  On the CPU every ray query is the plain version,
so the paths must agree bit for bit (torch.equal), on one CPU thread
(torch_port_util.one_thread).  The launch counts mock the two kernel
wrappers (as chip_smoke.capture_launches does) and count the calls that
would launch a kernel on the card.
"""

import importlib

import pytest
import torch

import redner_tpu_torch as rtt
from redner_tpu_torch import edge as tedge
from redner_tpu_torch.ops import intersect_cuda as ic
from redner_tpu_torch.scene import scene_leaves
from tests.scene_util import shadow_scene
from tests.torch_port_util import (one_thread, port_scene,  # noqa: F401
                                   two_torch_threads)

# The package exports the function `render`, which shadows the module
# attribute.
trender = importlib.import_module("redner_tpu_torch.render")

SEED = 5
REPLAY = dict(num_samples=4, max_bounces=2, isect_replay_max_mb=256.0)


@pytest.fixture(scope="module")
def scene():
    return port_scene(shadow_scene(res=(16, 16)))


def _weight(scene):
    g = torch.Generator().manual_seed(0)
    return torch.rand((16, 16, 3), generator=g)


def _scene_grads(scene, options, seed=SEED):
    """Image and d <render(scene), w> / d every float leaf."""
    leaves = scene_leaves(scene)
    for x in leaves:
        x.requires_grad_(True)
    try:
        img = rtt.render(scene, options, seed=seed)
        grads = torch.autograd.grad(torch.sum(img * _weight(scene)), leaves,
                                    allow_unused=True)
    finally:
        for x in leaves:
            x.requires_grad_(False)
    return img.detach(), grads


def _equal_grads(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        assert (ga is None) == (gb is None)
        if ga is not None:
            assert torch.equal(ga, gb)


def _rerender(scene, opts, d):
    """The backward's re-render (render._render_image_impl with the fused
    secondary surrogate) under grad -> (image, surrogate, d <image, d> +
    surrogate / d every float leaf)."""
    leaves = scene_leaves(scene)
    for x in leaves:
        x.requires_grad_(True)
    try:
        img, surr = trender._render_image_impl(scene, opts, SEED,
                                               secondary_d_radiance=d)
        g = torch.autograd.grad(torch.sum(img * d) + surr, leaves,
                                allow_unused=True)
    finally:
        for x in leaves:
            x.requires_grad_(False)
    return img.detach(), surr.detach(), g


def test_remat_rerender_and_surrogate_equal_live(scene, monkeypatch,
                                                 one_thread):
    """Four checkpointed passes (SAMPLES_LANE_TARGET = 256 lanes): the
    re-render's image, surrogate and their gradients equal the live ones."""
    monkeypatch.setattr(trender, "SAMPLES_LANE_TARGET", 256)
    d = _weight(scene)
    img_l, surr_l, g_l = _rerender(scene, rtt.RenderOptions(
        num_samples=4, max_bounces=2), d)
    img_r, surr_r, g_r = _rerender(scene, rtt.RenderOptions(
        num_samples=4, max_bounces=2, remat=True), d)
    assert torch.equal(img_r, img_l)
    assert torch.equal(surr_r, surr_l)
    assert float(surr_l.abs()) > 0
    _equal_grads(g_r, g_l)


@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no_grad"])
def test_remat_checkpoints_each_pass_under_grad(scene, monkeypatch, grad):
    """One checkpoint per pass where autograd records, none in a forward
    without grad (the forward of render's autograd.Function)."""
    monkeypatch.setattr(trender, "SAMPLES_LANE_TARGET", 256)
    calls = []
    real = trender.checkpoint

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(trender, "checkpoint", spy)
    opts = rtt.RenderOptions(num_samples=4, max_bounces=1, remat=True)
    with torch.set_grad_enabled(grad):
        trender._render_image_impl(scene, opts, SEED)
    assert len(calls) == (4 if grad else 0)
    assert all(kw["use_reentrant"] is False for kw in calls)


def test_remat_keeps_no_pass_residuals(scene, monkeypatch):
    """The point of remat: autograd keeps the passes' residuals only inside
    the checkpoints (recomputed in the backward), so the tensors saved
    outside them are a small share of the live re-render's."""
    monkeypatch.setattr(trender, "SAMPLES_LANE_TARGET", 256)
    d = _weight(scene)

    def saved_bytes(remat):
        total = [0]

        def pack(x):
            total[0] += x.numel() * x.element_size()
            return x

        leaves = scene_leaves(scene)
        for x in leaves:
            x.requires_grad_(True)
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
                trender._render_image_impl(
                    scene, rtt.RenderOptions(num_samples=4, max_bounces=2,
                                             remat=remat),
                    SEED, secondary_d_radiance=d)
        finally:
            for x in leaves:
                x.requires_grad_(False)
        return total[0]

    live, remat = saved_bytes(False), saved_bytes(True)
    assert live > 0
    assert remat < 0.1 * live


@pytest.mark.parametrize("chunk", [1, 40 * tedge.RESAMPLE_M])
def test_edge_candidate_runs_equal_one_run(scene, monkeypatch, one_thread,
                                           chunk):
    """The secondary-edge candidate draw over runs of lanes
    (edge.CANDIDATE_CHUNK bounds its working set): one lane a run, or
    some forty, gives the gradient of one run over all lanes."""
    opts = rtt.RenderOptions(num_samples=4, max_bounces=2)
    monkeypatch.setattr(tedge, "CANDIDATE_CHUNK", 1 << 40)
    _, g_one = _scene_grads(scene, opts)
    monkeypatch.setattr(tedge, "CANDIDATE_CHUNK", chunk)
    _, g_runs = _scene_grads(scene, opts)
    _equal_grads(g_runs, g_one)
    assert float(g_one[0].abs().max()) > 0


def test_render_gradient_with_replay_equals_live(scene, one_thread):
    """isect_replay_max_mb is accepted and gives the live gradient."""
    img_l, g_l = _scene_grads(scene, rtt.RenderOptions(
        num_samples=4, max_bounces=2))
    img_r, g_r = _scene_grads(scene, rtt.RenderOptions(**REPLAY))
    assert torch.equal(img_r, img_l)
    _equal_grads(g_r, g_l)
    assert float(g_l[-1].abs().max()) > 0  # the light intensity


def test_remat_gradient_equals_live(scene, one_thread):
    img_l, g_l = _scene_grads(scene, rtt.RenderOptions(
        num_samples=4, max_bounces=2))
    img_r, g_r = _scene_grads(scene, rtt.RenderOptions(
        num_samples=4, max_bounces=2, remat=True))
    assert torch.equal(img_r, img_l)
    _equal_grads(g_r, g_l)


@pytest.mark.parametrize("mode,expected", [
    ("live", (32, 16)),
    ("replay", (32, 16)),
    ("remat", (48, 24)),
])
def test_launches_per_gradient(scene, monkeypatch, mode, expected):
    """The slice's launch pattern at 16x16: four passes of 256 lanes
    (SAMPLES_LANE_TARGET) and four primary-edge chunks of 512 offset rays
    (EDGE_EVAL_CHUNK: 1,024 edge samples, a ray pair each).
    Live: forward 8 + 4, re-render 8 + 4, secondary pairs 8 + 4, primary
    edges 8 + 4.  isect_replay_max_mb changes nothing; remat runs the
    re-render and the secondary pairs again in the backward."""
    monkeypatch.setattr(trender, "SAMPLES_LANE_TARGET", 256)
    monkeypatch.setattr(tedge, "EDGE_EVAL_CHUNK", 512)
    counts = {"closest_hit": 0, "any_hit": 0}
    wrappers = {"closest_hit": ic.closest_hit, "any_hit": ic.any_hit}

    def counting(kind):
        def run(lay, rb):
            counts[kind] += 1
            return wrappers[kind](lay, rb)
        return run

    monkeypatch.setattr(ic, "closest_hit", counting("closest_hit"))
    monkeypatch.setattr(ic, "any_hit", counting("any_hit"))
    kw = dict(num_samples=4, max_bounces=1)
    if mode == "replay":
        kw["isect_replay_max_mb"] = 256.0
    elif mode == "remat":
        kw["remat"] = True
    _scene_grads(scene, rtt.RenderOptions(**kw))
    assert (counts["closest_hit"], counts["any_hit"]) == expected
