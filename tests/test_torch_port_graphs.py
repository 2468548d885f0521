"""The compiled render's CPU side: make_render against the JAX package's
make_render, the device seed, the device-counted work list and the cache
key of redner_tpu_torch.graphs.

make_render(options)(scene, seed) against redner_tpu.render_grad
.make_render(options) on shadow_scene at 16x16, 2 spp, 1 bounce: the image
at rtol 1e-4, the gradients of a weighted image sum at rtol 1e-3 (atol
1e-5 x max), one JAX compile in a module fixture.  A seed given as a
tensor draws and renders bit for bit as the same int seed, the
decorrelated seed + 1 wrapping on the device.  The kernels' work list
(capacity plus a count on the device) holds in its first count rows the
list the nonzero-based construction gave.  The graphs themselves are card
tests (tests/test_torch_port_cuda.py): on the CPU, render runs make_render's
eager function and captures nothing."""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

import redner_tpu as rt
import redner_tpu_torch as rtt
from redner_tpu_torch import graphs
from redner_tpu_torch import sampler as sampler_mod
from redner_tpu_torch.ops import intersect_cuda as ic
from redner_tpu_torch.scene import scene_leaves, scene_with_leaves
from tests.scene_util import shadow_scene
from tests.torch_port_util import (one_thread, port_scene,  # noqa: F401
                                   two_torch_threads)

U32 = 0xFFFFFFFF
SEED = 7
RES = (16, 16)
OPTS = dict(num_samples=2, max_bounces=1)


def _weight():
    return np.random.default_rng(0).uniform(0.5, 1.5, RES + (3,)).astype(
        np.float32)


def _port_leaves(ts):
    return ([ts.materials[0].diffuse_reflectance.texels,
             ts.area_lights[0].intensity]
            + [s.vertices for s in ts.shapes] + [ts.camera.position])


def _port_grads(render, ts, seed, weight):
    leaves = _port_leaves(ts)
    for x in leaves:
        x.requires_grad_(True)
    try:
        img = render(ts, seed)
        grads = torch.autograd.grad(
            torch.sum(img * torch.as_tensor(weight)), leaves)
    finally:
        for x in leaves:
            x.requires_grad_(False)
    return img.detach(), [g.numpy() for g in grads]


@pytest.fixture(scope="module")
def jax_make_render():
    """redner_tpu.render_grad.make_render's image and gradients of
    sum(image * weight) w.r.t. (diffuse, intensity, per-shape vertices,
    camera position), jitted once."""
    import jax
    import jax.numpy as jnp

    from redner_tpu.render_grad import make_render

    scene = shadow_scene(res=RES)
    fn = make_render(rt.RenderOptions(**OPTS), correlated=True)
    w = _weight()

    def loss(params):
        diffuse, intensity, verts, cam_pos = params
        mat = scene.materials[0]
        mat = mat.replace(diffuse_reflectance=mat.diffuse_reflectance.replace(
            texels=diffuse))
        sc = scene.replace(
            materials=(mat,),
            area_lights=(scene.area_lights[0].replace(intensity=intensity),),
            shapes=tuple(s.replace(vertices=v)
                         for s, v in zip(scene.shapes, verts)),
            camera=scene.camera.replace(position=cam_pos))
        img = fn(sc, jnp.asarray(SEED, jnp.uint32))
        return jnp.sum(img * w), img

    params = (scene.materials[0].diffuse_reflectance.texels,
              scene.area_lights[0].intensity,
              tuple(s.vertices for s in scene.shapes), scene.camera.position)
    (_, img), (g_diffuse, g_int, g_verts, g_pos) = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    grads = [np.asarray(g_diffuse), np.asarray(g_int),
             *(np.asarray(g) for g in g_verts), np.asarray(g_pos)]
    return scene, np.asarray(img), grads


def test_make_render_matches_jax_make_render(jax_make_render):
    scene, ref_img, ref = jax_make_render
    img, got = _port_grads(rtt.make_render(rtt.RenderOptions(**OPTS)),
                           port_scene(scene), SEED, _weight())
    np.testing.assert_allclose(img.numpy(), ref_img, rtol=1e-4,
                               atol=1e-6 * np.abs(ref_img).max())
    names = ["diffuse", "intensity", "floor", "blocker", "light", "cam_pos"]
    for name, g, r in zip(names, got, ref):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=1e-3,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)
    assert np.abs(ref[3]).max() > 0  # the blocker moves the shadow


@pytest.mark.parametrize("seed", [0, 2**31, U32, -1])
@pytest.mark.parametrize("sampler", list(rtt.SamplerType))
def test_device_seed_draws_bit_equal(seed, sampler):
    """A seed tensor keys the same uniforms as the int (negative ints wrap
    to 32 bits), and so does the edge passes' offset seed made from it."""
    lanes = torch.arange(300)
    sid = torch.arange(300) % 3
    as_tensor = torch.tensor(seed, dtype=torch.int64)
    for dim in (0, 5, 130):  # the table, and past it (the hash)
        a = sampler_mod.draw(sampler, seed, lanes, sid, dim, 3)
        b = sampler_mod.draw(sampler, as_tensor, lanes, sid, dim, 3)
        assert torch.equal(a, b)
    e_int = (seed + sampler_mod.EDGE_SEED_OFFSET) & U32
    e_dev = (sampler_mod._as_u32(as_tensor, "cpu")
             + sampler_mod.EDGE_SEED_OFFSET) & U32
    assert int(e_dev) == e_int
    assert torch.equal(sampler_mod.uniforms(e_int, lanes, 0, 0, 2),
                       sampler_mod.uniforms(e_dev, lanes, 0, 0, 2))


@pytest.mark.parametrize("seed", [0, 2**31, U32])
def test_device_seed_renders_bit_equal(seed):
    ts = port_scene(shadow_scene(res=RES))
    opts = rtt.RenderOptions(**OPTS)
    ref = rtt.render_image(ts, opts, seed=seed)
    assert torch.equal(rtt.render_image(ts, opts, seed=torch.tensor(seed)),
                       ref)


def test_decorrelated_seed_wraps_on_the_device(one_thread):  # noqa: F811
    """The decorrelated backward re-renders at (seed + 1) mod 2^32 on the
    device: at seed 2^32 - 1 its gradient is the correlated one at 0."""
    ts = port_scene(shadow_scene(res=RES))
    opts = rtt.RenderOptions(**OPTS)
    w = _weight()
    _, dec = _port_grads(rtt.make_render(opts, correlated=False), ts, U32, w)
    _, cor = _port_grads(rtt.make_render(opts, correlated=True), ts, 0, w)
    for g, r in zip(dec, cor):
        np.testing.assert_array_equal(g, r)


def _nonzero_work_list(mask):
    """The work list as the launcher built it before it had a device
    count: torch.nonzero, then the rank-major order."""
    nz = torch.nonzero(mask)
    rank = (torch.cumsum(mask, dim=1) - 1)[nz[:, 0], nz[:, 1]]
    return nz[torch.argsort(rank * mask.shape[0] + nz[:, 0])]


@st.composite
def _masks(draw):
    ntile = draw(st.integers(1, 40))
    nchunks = draw(st.integers(1, 24))
    density = draw(st.sampled_from([0.0, 0.1, 0.5, 1.0]))
    seed = draw(st.integers(0, 2**31))
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(ntile, nchunks)) < density


@settings(max_examples=60, deadline=None)
@given(_masks())
@example(np.zeros((7, 5), bool))
@example(np.ones((7, 5), bool))
@example(np.ones((1, 1), bool))
def test_work_list_prefix_equals_nonzero_list(mask):
    m = torch.as_tensor(mask)
    pairs, count = ic._active_lists(m)
    assert pairs.shape == (mask.size, 2) and pairs.dtype == torch.int32
    assert count.shape == (1,) and count.dtype == torch.int32
    n = int(count)
    assert n == int(mask.sum())
    ref = _nonzero_work_list(m)
    assert torch.equal(pairs[:n].to(torch.int64), ref)
    rank = (np.cumsum(mask, axis=1) - 1)[ref[:, 0], ref[:, 1]]
    assert (np.diff(rank * mask.shape[0] + ref[:, 0].numpy()) > 0).all()


def _key(scene, options=None, correlated=True, engine=None):
    return graphs.cache_key("render", scene,
                            options or rtt.RenderOptions(**OPTS),
                            correlated, engine)


def test_cache_key_is_the_structure():
    """Equal for the same structure with other values; different when the
    resolution, a tensor's requires_grad, an integer tensor's shape, the
    options, the engine or the correlated flag differ."""
    ts = port_scene(shadow_scene(res=RES))
    key = _key(ts)
    hash(key)
    other = scene_with_leaves(ts, [x + 0.5 for x in scene_leaves(ts)])
    assert _key(other) == key
    floor = ts.shapes[0]
    flipped = dataclasses.replace(floor, indices=floor.indices.flip(1))
    assert _key(dataclasses.replace(
        ts, shapes=(flipped,) + ts.shapes[1:])) == key
    assert _key(port_scene(shadow_scene(res=(16, 12)))) != key
    grad = port_scene(shadow_scene(res=RES))
    grad.shapes[1].vertices.requires_grad_(True)
    assert _key(grad) != key
    one_tri = dataclasses.replace(floor, indices=floor.indices[:1])
    assert _key(dataclasses.replace(
        ts, shapes=(one_tri,) + ts.shapes[1:])) != key
    assert _key(ts, rtt.RenderOptions(num_samples=3, max_bounces=1)) != key
    assert _key(ts, engine="plain") != key
    assert _key(ts, correlated=False) != key


def test_render_is_make_render_on_the_cpu(one_thread):  # noqa: F811
    """On the CPU render runs make_render's eager function: the same image
    and gradients bit for bit, and no program is made or captured."""
    ts = port_scene(shadow_scene(res=RES))
    opts = rtt.RenderOptions(**OPTS)
    w = _weight()
    captures = dict(graphs.CAPTURES)
    cached = len(graphs._cache)
    img, got = _port_grads(lambda s, seed: rtt.render(s, opts, seed=seed),
                           ts, SEED, w)
    img_e, ref = _port_grads(rtt.make_render(opts), ts, SEED, w)
    assert torch.equal(img, img_e)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert graphs.CAPTURES == captures and len(graphs._cache) == cached


def test_cache_key_follows_module_constants(monkeypatch):
    """A graph bakes in the module constants a render reads at each call
    (edge's estimator constants, the lane target): changing one changes
    the key, so no stale graph replays."""
    import importlib

    from redner_tpu_torch import edge

    ts = port_scene(shadow_scene(res=RES))
    key = _key(ts)
    monkeypatch.setattr(edge, "CANDIDATE_CHUNK", edge.CANDIDATE_CHUNK // 2)
    assert _key(ts) != key
    monkeypatch.undo()
    assert _key(ts) == key
    render_mod = importlib.import_module("redner_tpu_torch.render")
    monkeypatch.setattr(render_mod, "SAMPLES_LANE_TARGET", 256)
    assert _key(ts) != key
