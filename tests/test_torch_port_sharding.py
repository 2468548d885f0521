"""The port's multi-rank rendering (redner_tpu_torch.parallel.sharding) on
gloo ranks of this CPU host, against the one-process port on the single
triangle scene (tests/test_sharding.py's checks): the image within atol
1e-6, gradients within rtol 1e-4, in worlds of 2 and 3 (256 pixels do not
divide over 3: the padding), every rank holding the one-process gradient,
and the train step descending.  Second derivatives through render_sharded
and render_image_sharded (tests/test_torch_port_second_order.py's scene):
render's against JAX's recorded values, both against the one-process port
within 1e-5 relative, under a loss that couples pixels too, every rank
equal and issuing the same collectives; and the firefly clamp's gradient
over split lanes.

Imports torch and the port only: the ranks are spawned processes, which
import tests/torch_port_spawn.py.
"""

import numpy as np
import pytest
import torch

import redner_tpu_torch as rtt
from redner_tpu_torch.core.shardutil import lane_block
from redner_tpu_torch.parallel.sharding import (Mesh, make_mesh,
                                                pixel_sharding,
                                                render_image_sharded,
                                                render_sharded)
from redner_tpu_torch.parallel.spawn import run_ranks
from tests.test_torch_port_second_order import JAX_RENDER_H
from tests.test_torch_port_second_order import _close as _jax_close
from tests.torch_port_spawn import (FEW_EDGE_OPTIONS, RENDER_OPTIONS,
                                    SECOND_ORDER_CASES, ad_gradient,
                                    edge_gradient, firefly_gradient,
                                    launches_per_gradient,
                                    second_derivative, sharded_results,
                                    single_triangle, train_losses)
from tests.torch_port_util import two_torch_threads  # noqa: F401

LEAVES = ("vertices", "diffuse", "light intensity", "camera position")


@pytest.fixture(scope="module")
def single():
    """The one-process references, on one thread as the ranks run."""
    keep = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        opts = rtt.RenderOptions(**RENDER_OPTIONS)
        scene = single_triangle()
        with torch.no_grad():
            image = rtt.render_image(scene, opts, seed=0)
        edge_image, edge_grads = edge_gradient(scene, opts, 1)
        ad_image, ad_grads = ad_gradient(scene, opts, 1)
        _, few_edge_grads = edge_gradient(
            scene, rtt.RenderOptions(**FEW_EDGE_OPTIONS), 1)
        losses, _ = train_losses(make_mesh("cpu"))
        second_order = {case: second_derivative(*case)[0]
                        for case in SECOND_ORDER_CASES}
        firefly = firefly_gradient()
    finally:
        torch.set_num_threads(keep)
    return {"image": image, "edge_image": edge_image,
            "edge_grads": edge_grads, "ad_image": ad_image,
            "ad_grads": ad_grads, "few_edge_grads": few_edge_grads,
            "losses": losses, "second_order": second_order,
            "firefly": firefly}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each rank's results in a world of 2 (with the train step) and 3."""
    return {
        2: run_ranks(2, sharded_results, ((16, 16), True),
                     tmp_path_factory.mktemp("world2")),
        3: run_ranks(3, sharded_results, ((16, 16), False),
                     tmp_path_factory.mktemp("world3")),
    }


def _close(got, ref, rtol=1e-4):
    torch.testing.assert_close(got, ref, rtol=rtol,
                               atol=1e-6 * float(ref.abs().max()))


@pytest.mark.parametrize("world", [2, 3])
def test_render_image_sharded_matches_one_process(single, worlds, world):
    for r in worlds[world]:
        assert r["world"] == world
        torch.testing.assert_close(r["image"], single["image"], rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(r["edge_image"], single["edge_image"],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("world", [2, 3])
def test_render_sharded_gradients_match_one_process(single, worlds, world,
                                                     leaf):
    ref = single["edge_grads"][leaf]
    assert float(ref.abs().max()) > 0
    for r in worlds[world]:
        _close(r["edge_grads"][leaf], ref)


@pytest.mark.parametrize("world", [2, 3])
def test_ad_gradients_of_render_image_sharded_match(single, worlds, world):
    for r in worlds[world]:
        torch.testing.assert_close(r["ad_image"], single["ad_image"], rtol=0,
                                   atol=1e-6)
        for leaf in LEAVES:
            _close(r["ad_grads"][leaf], single["ad_grads"][leaf])


@pytest.mark.parametrize("world", [2, 3])
def test_every_rank_holds_the_one_process_gradient(single, worlds, world):
    """Each leaf's gradient is summed over the ranks once: every rank holds
    the same gradient, the one-process one, not `world` times it."""
    ranks = worlds[world]
    for leaf in LEAVES:
        ref = single["edge_grads"][leaf]
        for r in ranks:
            assert torch.equal(r["edge_grads"][leaf],
                               ranks[0]["edge_grads"][leaf])
        ratio = float(torch.sum(ranks[0]["edge_grads"][leaf] * ref)
                      / torch.sum(ref * ref))
        assert abs(ratio - 1.0) < 1e-4, (leaf, ratio)


@pytest.mark.parametrize("world", [2, 3])
def test_rank_with_no_edge_samples(single, worlds, world):
    """Four primary-edge samples over three ranks: blocks of 2, 2 and 0.
    The rank with none joins the gradient's all-reduce with the rest."""
    if world == 3:
        assert lane_block(4, 2, 3) == (4, 4)
    for leaf in LEAVES:
        ref = single["few_edge_grads"][leaf]
        for r in worlds[world]:
            _close(r["few_edge_grads"][leaf], ref)


def test_train_step_descends_and_agrees_across_ranks(single, worlds):
    ranks = worlds[2]
    losses = ranks[0]["losses"]
    assert float(losses[-1]) < 0.5 * float(losses[0]), losses
    for r in ranks[1:]:
        assert torch.equal(r["losses"], losses)
        assert torch.equal(r["trained_diffuse"], ranks[0]["trained_diffuse"])
    torch.testing.assert_close(losses, single["losses"], rtol=1e-3, atol=0)


def test_launches_per_rank(worlds):
    """One process: forward 8 + 4, re-render 8 + 4, secondary pairs 8 + 4,
    primary edges 8 + 4 (1,024 samples in 4 chunks of 512 pair rays).  Per
    rank of two the passes keep their count over half the lanes, and the
    512 samples of a rank make 2 chunks: 28 + 14."""
    assert launches_per_gradient(make_mesh("cpu")) == (32, 16)
    for r in worlds[2]:
        assert r["launches"] == (28, 14)


def _relative(got, ref, rtol=1e-5):
    """Within rtol relative, elementwise and to rtol x the largest
    entry."""
    torch.testing.assert_close(got, ref, rtol=rtol,
                               atol=rtol * float(ref.abs().max()))


@pytest.mark.parametrize("world", [2, 3])
def test_render_sharded_second_derivative_matches_jax(single, worlds,
                                                      world):
    """h = d/dv sum(d/dv sum(img^2)) through render_sharded (both edge
    samplers) equals JAX's reverse over reverse, recorded in the
    second-order test, at that file's tolerance."""
    want = JAX_RENDER_H["both"]
    for r in worlds[world]:
        _jax_close(r["second_order"][("render", "square")][0].numpy(),
                   np.asarray(want))


@pytest.mark.parametrize("world", [2, 3])
def test_render_image_sharded_second_derivative_matches_one_process(
        single, worlds, world):
    """The same h through render_image_sharded equals the one-process
    port's (which the second-order test holds against JAX live)."""
    ref = single["second_order"][("render_image", "square")]
    assert float(ref.abs().max()) > 0
    for r in worlds[world]:
        _relative(r["second_order"][("render_image", "square")][0], ref)


@pytest.mark.parametrize("entry", ["render", "render_image"])
@pytest.mark.parametrize("world", [2, 3])
def test_pixel_coupling_second_derivative_matches_one_process(
        single, worlds, world, entry):
    """A loss that couples every pixel, sum(img)^2 + sum(img^2): a backward
    that kept only this rank's lanes of the image's cotangent, or that
    counted the ranks' sums `world` times, gives another h."""
    ref = single["second_order"][(entry, "coupled")]
    assert float(ref.abs().max()) > 0
    assert not torch.allclose(ref, single["second_order"][(entry, "square")])
    for r in worlds[world]:
        _relative(r["second_order"][(entry, "coupled")][0], ref)


@pytest.mark.parametrize("world", [2, 3])
def test_every_rank_holds_the_same_second_derivative(worlds, world):
    """Every rank ends with the same h and issued the same all-reduces, in
    the same order, of the same shapes, in both passes."""
    ranks = worlds[world]
    for case in SECOND_ORDER_CASES:
        h0, issued0 = ranks[0]["second_order"][case]
        assert issued0, case
        for r in ranks[1:]:
            h, issued = r["second_order"][case]
            assert torch.equal(h, h0), case
            assert issued == issued0, case


@pytest.mark.parametrize("world", [2, 3])
def test_second_derivative_with_an_empty_edge_block(single, worlds, world):
    """FEW_EDGE_OPTIONS: in the world of 3 the last rank draws no
    primary-edge sample, yet it joins both passes' collectives, and h
    equals the one-process one."""
    ref = single["second_order"][("few_edges", "square")]
    for r in worlds[world]:
        _relative(r["second_order"][("few_edges", "square")][0], ref)


@pytest.mark.parametrize("world", [2, 3])
def test_firefly_scale_gradient_over_split_lanes(single, worlds, world):
    """The clamp's population scale tau sums over every rank's lanes, and
    so does its derivative: the gradient of sum(scale * c) w.r.t. z,
    assembled from the ranks' blocks, equals one process's on the whole
    vector, where the clamp binds on some lanes."""
    _, scale, ref = single["firefly"]
    assert bool((scale < 1).any()) and bool((scale == 1).any())
    got = torch.zeros_like(ref)
    got_scale = torch.zeros_like(scale)
    for r in worlds[world]:
        lo, s, g = r["firefly"]
        got[lo:lo + g.shape[0]] = g
        got_scale[lo:lo + s.shape[0]] = s
    _relative(got_scale, scale)
    _relative(got, ref)


def test_a_failed_collective_raises_with_its_number(monkeypatch):
    """A collective that fails (a rank that issued another one times out
    at the group's timeout) raises naming which all-reduce of this rank
    it was; nothing retries it or runs one process instead."""
    from redner_tpu_torch.core import shardutil

    def timed_out(*args, **kwargs):
        raise RuntimeError("Timed out waiting 300000ms")

    monkeypatch.setattr(torch.distributed, "all_reduce", timed_out)
    before = shardutil.COLLECTIVES
    with pytest.raises(RuntimeError, match=r"all-reduce \d+ of this rank "
                       r"\(lane gather, shape \(4, 3\)\) failed"):
        shardutil.gather_lanes(torch.ones(2, 3), 0, 4,
                               Mesh(group=object(), rank=0, world=2,
                                    device=torch.device("cpu")))
    assert shardutil.COLLECTIVES == before + 1


def test_world_of_one_without_a_process_group(single):
    """make_mesh() with torch.distributed not initialised: one rank, no
    collectives, the one-process render and gradient."""
    assert not torch.distributed.is_initialized()
    mesh = make_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.world) == (None, 0, 1)
    opts = rtt.RenderOptions(**RENDER_OPTIONS)
    scene = single_triangle()
    keep = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            image = render_image_sharded(scene, opts, seed=0, mesh=mesh)
        edge_image, grads = edge_gradient(scene, opts, 1, mesh)
    finally:
        torch.set_num_threads(keep)
    assert torch.equal(image, single["image"])
    assert torch.equal(edge_image, single["edge_image"])
    for leaf in LEAVES:
        _close(grads[leaf], single["edge_grads"][leaf])


def test_lane_blocks_cover_every_lane_once():
    for n, world in ((258, 3), (256, 2), (7, 4), (1, 3), (5, 4), (4, 3)):
        blocks = [lane_block(n, r, world) for r in range(world)]
        assert blocks[0][0] == 0 and blocks[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))


def test_scene_on_another_device_raises():
    mesh = Mesh(group=None, rank=0, world=1, device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="renders on cuda:0"):
        rtt.render_image(single_triangle(res=(4, 4)),
                         rtt.RenderOptions(num_samples=1),
                         pixel_sharding=pixel_sharding(mesh))
    with pytest.raises(ValueError, match="not initialised"):
        make_mesh("cpu", group=object())
    with pytest.raises(ValueError, match="renders on cuda:0"):
        render_sharded(single_triangle(res=(4, 4)),
                       rtt.RenderOptions(num_samples=1), mesh=mesh)
