"""The port's AOV channels on the CPU: the pieces, against redner_tpu
where it has them.

The generic texture stack against JAX's (trilinear taps, zero padding),
the depth channel's gradient where rays miss, radiance at a nonzero
channel offset, no bounce without radiance, the primary-valid hook and
chip_smoke's aov renders at a tiny size.  The scene
(tests/torch_port_util.aov_scene) feeds every channel.  The whole-image
and full-channel gradient comparisons against JAX, which pay this
feature's two JAX compiles, are in tests/test_torch_port_aov_jax.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu_torch as rtt
from redner_tpu.scene import _fetch_material_stack as j_fetch_stack
from redner_tpu.texture import pack_texture as j_pack_texture
from redner_tpu_torch.channels import channel_dims
from redner_tpu_torch.render import trace_radiance
from redner_tpu_torch.scene import _fetch_material_stack as t_fetch_stack
from tests.torch_port_util import (aov_scene, port_scene,  # noqa: F401
                                   two_torch_threads)

SEED = 5


def _topts(**kw):
    return rtt.RenderOptions(channels=tuple(rtt.Channels), **kw)


def test_depth_gradient_finite_where_rays_miss():
    """Where a camera ray misses, the depth channel's point is the ray
    origin; the port keeps the camera-position gradient finite there (the
    reference's is NaN) and equal to the gradient with those pixels'
    weights zeroed."""
    ts = port_scene(aov_scene((8, 8)))
    opts = rtt.RenderOptions(channels=(rtt.Channels.depth,
                                       rtt.Channels.alpha),
                             num_samples=1, max_bounces=0,
                             use_primary_edge_sampling=False)
    pos = ts.camera.position.requires_grad_(True)
    img = rtt.render_image(ts, opts, seed=SEED)
    hit = img[..., 1:2].detach() > 0
    assert 0 < float(hit.float().mean()) < 1
    g_all, = torch.autograd.grad(img[..., :1].sum(), pos, retain_graph=True)
    g_hit, = torch.autograd.grad((img[..., :1] * hit).sum(), pos)
    assert torch.isfinite(g_all).all() and g_all.abs().max() > 0
    torch.testing.assert_close(g_all, g_hit, rtol=1e-6, atol=0.0)


def test_radiance_off_offset_zero():
    """Radiance at a nonzero offset, between two AOVs, equals the radiance
    of the all-channel render (the RNG is keyed the same)."""
    ts = port_scene(aov_scene((8, 8)))
    kw = dict(num_samples=1, max_bounces=1)
    some = (rtt.Channels.alpha, rtt.Channels.radiance, rtt.Channels.depth)
    full = rtt.render_image(ts, _topts(**kw), seed=SEED)
    part = rtt.render_image(ts, rtt.RenderOptions(channels=some, **kw),
                            seed=SEED)
    ci_full = rtt.ChannelInfo(tuple(rtt.Channels))
    ci_part = rtt.ChannelInfo(some)
    assert ci_part.radiance_dimension == 1
    for ch in some:
        a, b, d = ci_part.offset_of(ch), ci_full.offset_of(ch), \
            channel_dims(ch)
        np.testing.assert_array_equal(part[..., a:a + d].numpy(),
                                      full[..., b:b + d].numpy())


def test_no_radiance_runs_no_bounce():
    """Without the radiance channel no shadow or bounce ray is traced: the
    render makes one closest-hit query per pass."""
    from redner_tpu_torch import accel

    ts = port_scene(aov_scene((8, 8)))
    calls = {"intersect": 0, "occluded": 0}
    orig = accel.intersect, accel.occluded

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    accel.intersect = count("intersect", orig[0])
    accel.occluded = count("occluded", orig[1])
    try:
        rtt.render_image(ts, rtt.RenderOptions(
            channels=(rtt.Channels.position, rtt.Channels.uv),
            num_samples=2, max_bounces=3), seed=SEED)
    finally:
        accel.intersect, accel.occluded = orig
    assert calls == {"intersect": 1, "occluded": 0}


def test_trace_radiance_returns_emission():
    """return_emission (the secondary-edge pass's hook) leaves the radiance
    as it was and returns the first-hit emission, which is the whole
    radiance when no bounce is traced."""
    ts = port_scene(aov_scene((8, 8)))
    fs = rtt.flatten_scene(ts)
    from redner_tpu_torch.camera import sample_primary_rays

    jitter = torch.full((64, 2), 0.5)
    ray, rd = sample_primary_rays(ts.camera, jitter)
    for bounces in (1, 0):
        opts = rtt.RenderOptions(num_samples=1, max_bounces=bounces)
        rad, em = trace_radiance(fs, opts, SEED, torch.arange(64), 0, ray, rd,
                                 return_emission=True)
        plain = trace_radiance(fs, opts, SEED, torch.arange(64), 0, ray, rd)
        torch.testing.assert_close(rad, plain, rtol=0.0, atol=0.0)
    torch.testing.assert_close(em, rad, rtol=0.0, atol=0.0)
    assert float(em.abs().sum()) > 0


@pytest.mark.parametrize("channels", [16, 8])
def test_generic_stack_matches_jax(channels):
    """_fetch_material_stack against the JAX package's on the scene's two
    generic textures (trilinear mip taps, zero padding) at random uvs and
    footprints; a material without a texture reads zeros."""
    scene = aov_scene((4, 4))
    ts = port_scene(scene)
    rng = np.random.default_rng(0)
    n = 256
    uv = rng.uniform(-0.5, 1.5, (n, 2)).astype(np.float32)
    du = rng.uniform(-0.2, 0.2, (n, 2)).astype(np.float32)
    dv = rng.uniform(-0.2, 0.2, (n, 2)).astype(np.float32)
    mid = rng.integers(0, 3, n)
    stack = tuple(None if m.generic_texture is None
                  else j_pack_texture(m.generic_texture)
                  for m in scene.materials)
    ref = np.asarray(j_fetch_stack(stack, uv, du, dv, jnp.asarray(mid),
                                   channels))
    got = t_fetch_stack(rtt.flatten_scene(ts).mat_generic, torch.as_tensor(uv),
                        torch.as_tensor(du), torch.as_tensor(dv),
                        torch.as_tensor(mid), channels).numpy()
    assert got.shape == (n, channels)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert (got[mid == 2] == 0).all() and (got[:, 5:] == 0).all()
    assert np.abs(got[mid == 0, :5]).min() > 0


def test_generic_texture_leaves_and_material():
    """make_material(generic_texture=) takes an array or a Texture, and the
    generic texels become scene leaves, between roughness and the normal
    map."""
    from redner_tpu_torch.scene import scene_leaves

    m = rtt.make_material(generic_texture=np.ones((4, 4, 2), np.float32),
                          device="cpu")
    assert isinstance(m.generic_texture, rtt.Texture)
    assert m.generic_texture.texels.shape == (4, 4, 2)
    ts = port_scene(aov_scene((4, 4)))
    ids = [id(x) for x in scene_leaves(ts)]
    m0 = ts.materials[0]
    pos = [ids.index(id(x)) for x in (m0.roughness.texels,
                                      m0.generic_texture.texels,
                                      m0.normal_map.texels)]
    assert pos == sorted(pos)


def test_chip_smoke_aov_renders_on_cpu():
    """chip_smoke's aov phase renders through the user utilities at a tiny
    size on the CPU: every output finite and of the expected shape, every
    gradient leaf reached."""
    from chip_smoke import AOV_LEAVES, AOV_RENDERS, aov_render, \
        make_envtex_scene

    scene = make_envtex_scene(res=(8, 8), theta=8, phi=16, tex=16,
                              env=(8, 16), generic=16, device="cpu")
    fs = rtt.flatten_scene(scene)
    assert fs.mat_generic[0].channels == 16 and fs.mat_generic[1] is None
    assert scene.shapes[1].colors is not None
    shapes = {"g_buffer": (8, 8, 47), "deferred": (8, 8, 4),
              "pathtracing": (8, 8, 3), "screen_gradient": (8, 8, 2, 3)}
    for name in AOV_RENDERS:
        out, grads = aov_render(name, scene,
                                grad=name != "screen_gradient")
        assert tuple(out.shape) == shapes[name], name
        assert torch.isfinite(out).all() and out.abs().max() > 0, name
        for leaf, g in zip(AOV_LEAVES.get(name, ()), grads or ()):
            assert torch.isfinite(g).all() and g.abs().max() > 0, (name, leaf)
