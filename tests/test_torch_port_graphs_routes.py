"""The routes that replay CUDA graphs since the whole port is compiled, on
their CPU side: the bodies those graphs capture, run eagerly, against the
JAX package and against the port's eager routes; the mesh in the graph
cache's key; and the choice of route by the process group's backend.

On shadow_scene at 16x16, 2 spp, 1 bounce, seed 7:

  * render_image's continuous backward (the "render_image_grad" program:
    render's backward body with both edge samplers off, at the forward's
    options and seed) against jax.grad of redner_tpu.render_image
    (gradients rtol 1e-3, atol 1e-5 x max; one JAX compile in a module
    fixture) and against eager autograd through rtt.render_image (rtol
    1e-5, atol 1e-7 x max), with and without remat;
  * render's and render_image_grad's forward and backward bodies on two
    gloo ranks (tests/torch_port_spawn.program_bodies) against one process:
    every pixel within atol 1e-6, each leaf's gradient within relative L2
    1e-4;
  * the cache key differs by rank, world size and backend, and a key does
    not outlive its process group;
  * a gloo group routes to the eager function, chosen from its backend;
  * screen_gradient_image with tensor seeds 0 and 2^32 - 1 against
    redner_tpu.screen_gradient_image (tests/test_torch_port_screen_gradient
    .py's tolerance: rtol 1e-3, atol 1e-5 x max; one JAX compile).

The graphs themselves are card tests (tests/test_torch_port_cuda.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import redner_tpu as rt
import redner_tpu_torch as rtt
from redner_tpu.screen_gradient import screen_gradient_image as j_sg
from redner_tpu_torch import graphs
from redner_tpu_torch.parallel.sharding import Mesh, make_mesh
from redner_tpu_torch.parallel.spawn import run_ranks
from redner_tpu_torch.render_grad import _render_image_program
from redner_tpu_torch.scene import scene_tensors
from tests.scene_util import shadow_scene
from tests.torch_port_spawn import program_bodies, with_grad_leaves
from tests.torch_port_util import (one_thread, port_scene,  # noqa: F401
                                   two_torch_threads)

U32 = 0xFFFFFFFF
SEED = 7
RES = (16, 16)
OPTS = dict(num_samples=2, max_bounces=1)
NAMES = ("diffuse", "intensity", "floor", "blocker", "light", "cam_pos")


def _weight():
    return np.random.default_rng(0).uniform(0.5, 1.5, RES + (3,)).astype(
        np.float32)


def _seed():
    return torch.tensor(SEED, dtype=torch.int64)


def rel_l2(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _continuous_body(ts, options):
    """The render_image_grad program's forward image and backward
    gradients of sum(image * weight) w.r.t. with_grad_leaves(ts)."""
    leaves = with_grad_leaves(ts)
    prog = _render_image_program(options, None)(ts)
    img = prog._forward_body(ts, _seed())
    grads = prog._backward_body(ts, _seed(), torch.as_tensor(_weight()))
    at = {id(t): i for i, t in enumerate(scene_tensors(ts))}
    return img, [grads[at[id(x)]] for x in leaves]


@pytest.fixture(scope="module")
def jax_render_image_grad():
    """jax.grad of sum(redner_tpu.render_image(scene) * weight) w.r.t.
    (diffuse, intensity, per-shape vertices, camera position) and the
    image, jitted once."""
    scene = shadow_scene(res=RES)
    opts = rt.RenderOptions(**OPTS)
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
        img = rt.render_image(sc, opts, jnp.asarray(SEED, jnp.uint32))
        return jnp.sum(img * w), img

    params = (scene.materials[0].diffuse_reflectance.texels,
              scene.area_lights[0].intensity,
              tuple(s.vertices for s in scene.shapes), scene.camera.position)
    (_, img), (g_diffuse, g_int, g_verts, g_pos) = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    grads = [np.asarray(g_diffuse), np.asarray(g_int),
             *(np.asarray(g) for g in g_verts), np.asarray(g_pos)]
    return scene, np.asarray(img), grads


def test_continuous_backward_body_matches_jax_grad(jax_render_image_grad):
    scene, ref_img, ref = jax_render_image_grad
    img, got = _continuous_body(port_scene(scene), rtt.RenderOptions(**OPTS))
    np.testing.assert_allclose(img.detach().numpy(), ref_img, rtol=1e-4,
                               atol=1e-6 * np.abs(ref_img).max())
    for name, g, r in zip(NAMES, got, ref):
        g = g.numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=1e-3,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)
    assert np.abs(ref[3]).max() > 0  # the blocker's shading moves


@pytest.mark.parametrize("remat", [False, True])
def test_continuous_backward_body_is_eager_autograd(remat,
                                                    one_thread):  # noqa: F811
    """The graphed backward's body gives what autograd through the eager
    render_image gives, remat's checkpointed passes included."""
    options = rtt.RenderOptions(remat=remat, **OPTS)
    ts = port_scene(shadow_scene(res=RES))
    img, got = _continuous_body(ts, options)
    with graphs.disable():
        e_img = rtt.render_image(ts, options, seed=SEED)
        ref = torch.autograd.grad(
            torch.sum(e_img * torch.as_tensor(_weight())),
            with_grad_leaves(ts))
    assert torch.equal(img, e_img.detach())
    for name, g, r in zip(NAMES, got, ref):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-7 * float(r.abs().max()),
                                   err_msg=name)


def test_sharded_bodies_match_one_process(tmp_path):
    """render's and render_image_grad's graph bodies over two gloo ranks
    give every rank the one-process image and gradients."""
    ts = port_scene(shadow_scene(res=RES))
    ct = torch.as_tensor(_weight())
    ranks = run_ranks(2, program_bodies, (ts, OPTS, SEED, ct), tmp_path)
    ref = program_bodies(port_scene(shadow_scene(res=RES)), OPTS, SEED, ct)
    for r, out in enumerate(ranks):
        for kind, (ref_img, ref_grads) in ref.items():
            img, grads = out[kind]
            torch.testing.assert_close(img.detach(), ref_img.detach(),
                                       rtol=0, atol=1e-6)
            for name, g, gr in zip(NAMES, grads, ref_grads):
                assert torch.isfinite(g).all(), (r, kind, name)
                assert rel_l2(g, gr) <= 1e-4, (r, kind, name, rel_l2(g, gr))
    assert all(torch.equal(a, b) for a, b in zip(
        ranks[0]["render"][1], ranks[1]["render"][1]))


@pytest.fixture
def gloo_world(tmp_path):
    """A gloo process group of one rank in this process, destroyed after
    the test; the graph cache emptied around it."""
    graphs.clear()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield make_mesh("cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        graphs.clear()


def _key(scene, sharding):
    return graphs.cache_key("render", scene, rtt.RenderOptions(**OPTS),
                            True, None, sharding)


def test_cache_key_holds_the_mesh(gloo_world, monkeypatch):
    """Keys differ by rank, world size, backend and the presence of a
    group, and equal for the same mesh."""
    ts = port_scene(shadow_scene(res=RES))
    mesh = gloo_world
    assert mesh.group is not None and mesh.world == 1
    keys = [_key(ts, None), _key(ts, Mesh(None, 0, 1, mesh.device)),
            _key(ts, mesh), _key(ts, dataclasses.replace(mesh, rank=1)),
            _key(ts, dataclasses.replace(mesh, world=2))]
    assert _key(ts, make_mesh("cpu")) == keys[2]
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    keys.append(_key(ts, mesh))
    assert len(set(keys)) == len(keys)


def test_key_does_not_outlive_its_group(gloo_world, tmp_path):
    """A program keyed on a group is dropped at the first lookup after the
    group is destroyed; a new group of the same ranks keys anew."""
    ts = port_scene(shadow_scene(res=RES))
    opts = rtt.RenderOptions(**OPTS)
    made = []

    def make(scene):
        made.append(object())
        return made[-1]

    first = graphs.program("render", ts, opts, True, None, make, gloo_world)
    assert graphs.program("render", ts, opts, True, None, make,
                          gloo_world) is first
    dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv2",
                            rank=0, world_size=1)
    second = graphs.program("render", ts, opts, True, None, make,
                            make_mesh("cpu"))
    assert second is not first and len(made) == 2
    assert len(graphs._cache) == 1


def test_gloo_group_routes_to_the_eager_function(gloo_world, monkeypatch):
    """A card scene replays graphs with no group and over NCCL, never over
    gloo or inside graphs.disable(); the choice reads the group's backend
    and captures nothing.  On the CPU a gloo mesh's render is make_render's
    eager function: the same image and gradients, no program made."""
    mesh = gloo_world
    cuda = torch.device("cuda", 0)
    assert graphs.replays(cuda) and graphs.replays(cuda, None)
    assert graphs.replays(cuda, Mesh(None, 0, 1, cuda))
    assert not graphs.replays(cuda, dataclasses.replace(mesh, device=cuda))
    assert not graphs.replays("cpu")
    with graphs.disable():
        assert not graphs.replays(cuda)
    assert graphs.replays(cuda)
    with monkeypatch.context() as m:
        m.setattr(dist, "get_backend", lambda group=None: "nccl")
        assert graphs.replays(cuda, dataclasses.replace(mesh, device=cuda))
    ts = port_scene(shadow_scene(res=RES))
    opts = rtt.RenderOptions(**OPTS)
    leaves = with_grad_leaves(ts)
    w = torch.as_tensor(_weight())
    captures = dict(graphs.CAPTURES)
    img = rtt.render(ts, opts, seed=SEED, pixel_sharding=mesh)
    got = torch.autograd.grad(torch.sum(img * w), leaves)
    e_img = rtt.make_render(opts, mesh)(ts, SEED)
    ref = torch.autograd.grad(torch.sum(e_img * w), leaves)
    assert torch.equal(img, e_img)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-7)
    assert graphs.CAPTURES == captures and not graphs._cache


def _sg_opts(mod):
    return mod.RenderOptions(
        channels=(mod.Channels.radiance, mod.Channels.alpha), **OPTS)


@pytest.fixture(scope="module")
def jax_screen_gradient():
    """redner_tpu.screen_gradient_image with primary edges, the seed a
    traced uint32: one compile for every seed."""
    scene = shadow_scene(res=RES)
    fn = jax.jit(lambda seed: j_sg(scene, _sg_opts(rt), seed))
    return lambda seed: np.asarray(fn(jnp.asarray(seed, jnp.uint32)))


@pytest.mark.parametrize("seed", [0, U32])
def test_screen_gradient_tensor_seed_matches_jax(seed, jax_screen_gradient):
    """A tensor seed (the graphs' device seed) gives JAX's image, and the
    same image as the int seed; at 2^32 - 1 the primary-edge seed offset
    wraps on the device."""
    ts = port_scene(shadow_scene(res=RES))
    got = rtt.screen_gradient_image(ts, _sg_opts(rtt),
                                    seed=torch.tensor(seed))
    ref = jax_screen_gradient(seed)
    assert got.shape == (16, 16, 2, 4)
    assert np.isfinite(got.numpy()).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3,
                               atol=1e-5 * np.abs(ref).max())
    assert np.abs(got.numpy()[..., 3]).max() > 0  # the silhouettes' jumps
    assert torch.equal(got, rtt.screen_gradient_image(ts, _sg_opts(rtt),
                                                      seed=seed))
