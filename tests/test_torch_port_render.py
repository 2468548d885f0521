"""The port's forward render against redner_tpu on the CPU.

Each scene is described once in redner_tpu, carried across by
redner_tpu_torch.scene_from_arrays, and rendered by both packages at the
same seed.  The RNG is stateless and bit-exact between them, so the images
agree to float rounding (rtol 1e-4, atol 1e-5 x image max), and so do the
continuous (AD-only) gradients of a weighted image sum (rtol 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu as rt
import redner_tpu_torch as rtt
from redner_tpu_torch.ops import intersect_cuda as tic
from tests.scene_util import shadow_scene, single_triangle_scene
from tests.torch_port_util import port_scene

SEED = 7


def _assert_image_close(got, ref):
    ref = np.asarray(ref)
    assert ref.max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * ref.max())


@pytest.mark.parametrize("make,options", [
    (single_triangle_scene, dict(num_samples=4, max_bounces=1)),
    (shadow_scene, dict(num_samples=4, max_bounces=2)),
], ids=["single_triangle", "shadow"])
def test_render_image_matches_reference(make, options):
    scene = make(res=(16, 16))
    ref = rt.render_image(scene, rt.RenderOptions(**options), seed=SEED)
    tscene = port_scene(scene)
    tic.reset_launch_counts()
    got = rtt.render_image(tscene, rtt.RenderOptions(**options), seed=SEED)
    assert got.shape == (16, 16, 3) and got.dtype == torch.float32
    _assert_image_close(got.numpy(), ref)
    # CPU tensors take the plain ray queries: no kernel launch, and forcing
    # the plain engine changes nothing.
    assert tic.LAUNCHES == {"closest_hit": 0, "any_hit": 0}
    plain = rtt.render_image(tscene, rtt.RenderOptions(**options), seed=SEED,
                             engine="plain")
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_continuous_gradients_match_jax():
    opts = dict(num_samples=2, max_bounces=1)
    scene = shadow_scene(res=(16, 16))
    weight = np.random.default_rng(0).uniform(0.5, 1.5, (16, 16, 3)).astype(
        np.float32)

    def jloss(params):
        diffuse, intensity, verts, cam_pos = params
        mat = scene.materials[0]
        mat = mat.replace(diffuse_reflectance=mat.diffuse_reflectance.replace(
            texels=diffuse))
        sc = scene.replace(
            materials=(mat,),
            area_lights=(scene.area_lights[0].replace(intensity=intensity),),
            shapes=tuple(s.replace(vertices=v)
                         for s, v in zip(scene.shapes, verts)),
            camera=scene.camera.replace(position=cam_pos),
        )
        img = rt.render_image(sc, rt.RenderOptions(**opts), seed=SEED)
        return jnp.sum(img * weight)

    params = (scene.materials[0].diffuse_reflectance.texels,
              scene.area_lights[0].intensity,
              tuple(s.vertices for s in scene.shapes),
              scene.camera.position)
    g_diffuse, g_int, g_verts, g_pos = jax.grad(jloss)(params)

    tscene = port_scene(scene)
    leaves = ([tscene.materials[0].diffuse_reflectance.texels,
               tscene.area_lights[0].intensity, tscene.camera.position]
              + [s.vertices for s in tscene.shapes])
    for x in leaves:
        x.requires_grad_(True)
    img = rtt.render_image(tscene, rtt.RenderOptions(**opts), seed=SEED)
    torch.sum(img * torch.as_tensor(weight)).backward()

    def close(got, ref):
        # atol: entries ~1e-7 of the largest differ in their last f32 bits.
        ref = np.asarray(ref)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=1e-3,
                                   atol=1e-5 * np.abs(ref).max())

    close(leaves[0].grad.numpy(), g_diffuse)
    close(leaves[1].grad.numpy(), g_int)
    close(leaves[2].grad.numpy(), g_pos)
    assert np.abs(np.asarray(g_pos)).max() > 0
    for s, g in zip(tscene.shapes, g_verts):
        close(s.vertices.grad.numpy(), g)


@pytest.mark.parametrize("option", [
    dict(channels=(rtt.Channels.radiance, rtt.Channels.depth)),
    dict(sampler_type=rtt.SamplerType.sobol),
    dict(remat=True),
    dict(split_shadow_sweep=False),
], ids=["aov_channels", "sobol", "remat", "batched_shadow_sweep"])
def test_unported_options_raise(option):
    tscene = port_scene(single_triangle_scene(res=(4, 4)))
    with pytest.raises(NotImplementedError):
        rtt.render_image(tscene, rtt.RenderOptions(**option))


def test_bench_scene_builds_on_cpu():
    """The user path of the slice's scene (generate_sphere + quad floor +
    generate_quad_light through scene_from_objects), at a tiny size."""
    from chip_smoke import make_slice_scene

    scene = make_slice_scene(res=(8, 8), theta=8, phi=16, device="cpu")
    fs = rtt.flatten_scene(scene)
    assert fs.num_triangles == 15 * 12 + 4
    img = rtt.render_image(scene, rtt.RenderOptions(num_samples=1), seed=11)
    assert torch.isfinite(img).all() and img.max() > 0
