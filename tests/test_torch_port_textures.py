"""The port's image textures against redner_tpu on the CPU: mipmaps, the
trilinear fetch, the MaterialBank and a textured, normal-mapped scene.

Module-level helpers compare redner_tpu_torch.texture with
redner_tpu.texture on the same numpy-seeded texels, uvs and footprints:
mip levels at rtol 1e-6 (13x7 exercises the antialiased linear resize of
non-divisible levels), fetched values at rtol 1e-5 and texel gradients at
rtol 1e-4 (negative uvs exercise the wrap; the JAX package's small tables
go through its one-hot matmul fetch, the port's through gathers).  The
three patterns of tests/test_material_bank.py run on the port.  The scene
test against JAX, which pays this module's scene's one JAX compile, is in
tests/test_torch_port_textures_scene.py: a file of its own, so that the
lane's workers take it after the files of many tests."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu as rt
import redner_tpu_torch as rtt
from redner_tpu import texture as jtex
from redner_tpu.scene import fetch_local_material as j_fetch_lm
from redner_tpu.scene import flatten_scene as j_flatten
from redner_tpu_torch import accel as taccel
from redner_tpu_torch import texture as ttex
from redner_tpu_torch.camera import sample_primary_rays
from redner_tpu_torch.render import _surface_point_at
from redner_tpu_torch.scene import fetch_local_material, flatten_scene
from tests.torch_port_util import (port_scene,  # noqa: F401
                                   two_torch_threads)

SEED = 5
OPTS = dict(num_samples=2, max_bounces=1)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _grad_close(got, ref):
    ref = np.asarray(ref)
    assert np.isfinite(got).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-6 * np.abs(ref).max())


# ---------------------------------------------------------------- mipmaps


@pytest.mark.parametrize("shape", [(8, 8, 3), (16, 4, 2), (13, 7, 3),
                                   (5, 3, 1)], ids=str)
def test_build_mipmap_matches_jax(shape):
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    ref = jtex.build_mipmap(jnp.asarray(x))
    got = ttex.build_mipmap(torch.as_tensor(x))
    assert len(got) == len(ref) <= ttex.MAX_MIP_LEVELS
    for a, b in zip(got, ref):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_pack_texture_layout_matches_jax():
    x = np.random.default_rng(1).uniform(0, 1, (13, 7, 3)).astype(np.float32)
    ref = jtex.pack_texture(jtex.make_texture(x))
    got = ttex.pack_texture(ttex.make_texture(x, device="cpu"))
    assert (got.widths, got.heights, got.offsets) == (
        ref.widths, ref.heights, ref.offsets)
    assert not got.pow2 and not got.is_constant
    np.testing.assert_array_equal(
        got.level_tab.numpy(), np.asarray([ref.widths, ref.heights,
                                           ref.offsets]))


# ------------------------------------------------------------------ fetch


def _lanes(n, seed):
    """uv with negative and > 1 values (the wrap), and screen footprints
    over five decades (every mip level)."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    mag = 10.0 ** rng.uniform(-4, 1, (n, 1))
    du = (rng.normal(0, 1, (n, 2)) * mag).astype(np.float32)
    dv = (rng.normal(0, 1, (n, 2)) * mag).astype(np.float32)
    du[:5] = 0.0  # zero ray differentials
    dv[:5] = 0.0
    w = rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32)
    return uv, du, dv, w


# 16x16 is a power-of-two table (bitwise wrap) under the JAX package's
# matmul fetch; 13x7 is not; 70x50 is past the matmul's 4,096-texel limit,
# so it meets the JAX package's gather fetch.
@pytest.mark.parametrize("shape", [(16, 16, 3), (13, 7, 3), (70, 50, 2)],
                         ids=str)
def test_texture_eval_matches_jax(shape):
    rng = np.random.default_rng(2)
    texels = rng.uniform(0, 1, shape).astype(np.float32)
    uv_scale = np.asarray([1.5, 0.75], np.float32)
    uv, du, dv, w = _lanes(300, seed=3)

    def jloss(tx, uvs):
        ptex = jtex.pack_texture(jtex.make_texture(tx, uv_scale=uvs))
        val = jtex.texture_eval(ptex, jnp.asarray(uv), jnp.asarray(du),
                                jnp.asarray(dv))
        return jnp.sum(val * w), val

    (_, ref), (rg_tex, rg_uv) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(texels),
                                              jnp.asarray(uv_scale))

    tx = torch.tensor(texels, requires_grad=True)
    uvs = torch.tensor(uv_scale, requires_grad=True)
    got = ttex.texture_eval(ttex.pack_texture(ttex.Texture(tx, uvs)),
                            _t(uv), _t(du), _t(dv))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    torch.sum(got * _t(w)).backward()
    _grad_close(tx.grad.numpy(), rg_tex)
    _grad_close(uvs.grad.numpy(), rg_uv)


def test_constant_texture_broadcasts():
    ptex = ttex.pack_texture(ttex.make_texture([0.2, 0.3], device="cpu"))
    out = ttex.texture_eval(ptex, torch.zeros((4, 2)), torch.zeros((4, 2)),
                            torch.zeros((4, 2)))
    assert out.shape == (4, 2) and torch.equal(out[3], torch.tensor([0.2, 0.3]))


_BANK_STACKS = {
    # Every size a power of two (bitwise wrap), two depths, a constant.
    "pow2": [[(8, 8, 3), (3,), (16, 16, 3)], [(4, 4, 1), (1,), (1,)]],
    # Odd and non-divisible sizes, an empty slot (a missing normal map).
    "non_pow2": [[(13, 7, 3), (8, 8, 3), (3,)], [(5, 3, 1), None, (1,)]],
}


@pytest.mark.parametrize("case", list(_BANK_STACKS))
def test_bank_eval_matches_jax(case):
    rng = np.random.default_rng(4)
    shapes = _BANK_STACKS[case]
    texels = [[None if s is None else rng.uniform(0, 1, s).astype(np.float32)
               for s in stack] for stack in shapes]
    n = 257
    uv, du, dv, w = _lanes(n, seed=6)
    slots = rng.integers(0, 6, n)

    def jbank(tx):
        stacks = [[None if t is None else jtex.pack_texture(jtex.make_texture(t))
                   for t in stack] for stack in tx]
        return jtex.pack_material_bank(stacks)

    def jloss(tx):
        bank = jbank(tx)
        val = jtex.bank_eval(bank, bank.tab[slots], jnp.asarray(uv),
                             jnp.asarray(du), jnp.asarray(dv))
        return jnp.sum(val * w), val

    jtx = [[None if t is None else jnp.asarray(t) for t in s] for s in texels]
    jb = jbank(jtx)
    (_, ref), rgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jtx)

    ttx = [[None if t is None else torch.tensor(t, requires_grad=True)
            for t in s] for s in texels]
    stacks = [[None if t is None else ttex.pack_texture(ttex.Texture(
        t, torch.ones(2))) for t in s] for s in ttx]
    bank = ttex.pack_material_bank(stacks)
    assert bank.Lmax == jb.Lmax and bank.pow2 == jb.pow2 == (case == "pow2")
    np.testing.assert_array_equal(bank.tab.numpy(), np.asarray(jb.tab))
    got = ttex.bank_eval(bank, bank.tab[_t(slots)], _t(uv), _t(du), _t(dv))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    torch.sum(got * _t(w)).backward()
    for ts, rs in zip(ttx, rgrad):
        for t, r in zip(ts, rs):
            if t is not None:
                _grad_close(t.grad.numpy(), r)


# ------------------------------------------- tests/test_material_bank.py


def _mixed_materials(make_material, make_texture):
    rng = np.random.default_rng(3)
    mats = []
    for i in range(3):  # constants
        mats.append(make_material(
            diffuse_reflectance=rng.uniform(0, 1, 3).astype(np.float32),
            roughness=np.asarray([0.1 + 0.1 * i], np.float32)))
    # textured diffuse (multi-level mip), constant elsewhere
    mats.append(make_material(
        diffuse_reflectance=rng.uniform(0, 1, (8, 8, 3)).astype(np.float32),
        specular_reflectance=np.asarray([0.2, 0.3, 0.4], np.float32),
        roughness=np.asarray([0.3], np.float32)))
    # textured roughness + normal map
    mats.append(make_material(
        diffuse_reflectance=np.asarray([0.6, 0.5, 0.4], np.float32),
        roughness=rng.uniform(0.05, 1.0, (4, 4, 1)).astype(np.float32),
        normal_map=make_texture(
            rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))))
    # a different mip depth
    mats.append(make_material(
        diffuse_reflectance=rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)))
    return mats


def _quad_scene(mats):
    cam = rtt.make_camera(position=[0.0, 0.0, -4.0], look_at=[0.0, 0.0, 0.0],
                          up=[0.0, 1.0, 0.0], fov=45.0, resolution=(4, 4),
                          device="cpu")
    quad = rtt.make_shape(
        vertices=[[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0],
                  [-1.0, 1.0, 0.0], [1.0, 1.0, 0.0]],
        indices=[[0, 2, 1], [1, 2, 3]], material_id=0, device="cpu")
    return rtt.make_scene(cam, [quad], mats)


def test_bank_matches_per_material_texture_eval():
    """fetch_local_material through the bank equals each lane's own
    material's texture_eval, on mixed constant and textured stacks; and
    equals the JAX package's fetch."""
    mk_mat = lambda **kw: rtt.make_material(device="cpu", **kw)
    mk_tex = lambda x: rtt.make_texture(x, device="cpu")
    mats = _mixed_materials(mk_mat, mk_tex)
    fs = flatten_scene(_quad_scene(mats))
    assert fs.mat_bank is not None and fs.mat_bank_pos == (0, -1, 1, 2)
    rng = np.random.default_rng(11)
    n = 257
    uv = rng.uniform(-0.2, 1.2, (n, 2)).astype(np.float32)
    du = rng.uniform(-0.1, 0.1, (n, 2)).astype(np.float32)
    dv = rng.uniform(-0.1, 0.1, (n, 2)).astype(np.float32)
    mid = rng.integers(0, len(mats), n)
    lm = fetch_local_material(
        fs, types.SimpleNamespace(uv=_t(uv), du_dxy=_t(du), dv_dxy=_t(dv)),
        _t(mid))

    def ref_stack(get, channels):
        out = np.zeros((n, channels), np.float32)
        for m, mat in enumerate(mats):
            tex = get(mat)
            if tex is None:
                continue
            val = ttex.texture_eval(ttex.pack_texture(tex), _t(uv), _t(du),
                                    _t(dv)).numpy()
            sel = mid == m
            out[sel, :val.shape[-1]] = val[sel][:, :channels]
        return out

    for got, get, ch in ((lm.diffuse, lambda m: m.diffuse_reflectance, 3),
                         (lm.specular, lambda m: m.specular_reflectance, 3),
                         (lm.roughness[:, None], lambda m: m.roughness, 1),
                         (lm.normal_value, lambda m: m.normal_map, 3)):
        np.testing.assert_allclose(got.numpy(), ref_stack(get, ch),
                                   rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(
        lm.has_normal_map.numpy(),
        [mats[m].normal_map is not None for m in mid])

    jmats = _mixed_materials(rt.make_material, rt.make_texture)
    jcam = rt.make_camera(position=[0.0, 0.0, -4.0], look_at=[0.0, 0.0, 0.0],
                          up=[0.0, 1.0, 0.0], fov=45.0, resolution=(4, 4))
    jquad = rt.make_shape(vertices=np.asarray(fs.vertices),
                          indices=[[0, 2, 1], [1, 2, 3]], material_id=0)
    jscene = rt.make_scene(jcam, [jquad], jmats)
    jlm = jax.jit(lambda sc: j_fetch_lm(
        j_flatten(sc),
        types.SimpleNamespace(uv=jnp.asarray(uv), du_dxy=jnp.asarray(du),
                              dv_dxy=jnp.asarray(dv)),
        jnp.asarray(mid, jnp.int32)))(jscene)
    for name in ("diffuse", "specular", "roughness", "normal_value"):
        np.testing.assert_allclose(getattr(lm, name).numpy(),
                                   np.asarray(getattr(jlm, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def _grid_scene(M=32, res=(64, 64), textured=(), envmap=None):
    """A grid of face-on quads, one material each."""
    rng = np.random.default_rng(7)
    cols = int(np.ceil(np.sqrt(M)))
    rows = int(np.ceil(M / cols))
    shapes, mats = [], []
    colors = rng.uniform(0.1, 1.0, (M, 3)).astype(np.float32)
    for m in range(M):
        cx = (m % cols - (cols - 1) / 2) * 2.2
        cy = (m // cols - (rows - 1) / 2) * 2.2
        shapes.append(rtt.make_shape(
            vertices=[[cx - 1, cy - 1, 0.0], [cx + 1, cy - 1, 0.0],
                      [cx - 1, cy + 1, 0.0], [cx + 1, cy + 1, 0.0]],
            indices=[[0, 2, 1], [1, 2, 3]],
            uvs=[[0, 0], [1, 0], [0, 1], [1, 1]],
            material_id=m, device="cpu"))
        tex = (np.broadcast_to(colors[m], (8, 8, 3)).copy() if m in textured
               else colors[m])
        mats.append(rtt.make_material(diffuse_reflectance=tex, device="cpu"))
    span = max(cols, rows) * 2.2
    cam = rtt.make_camera(
        position=[0.0, 0.0, -1.3 * span], look_at=[0.0, 0.0, 0.0],
        up=[0.0, 1.0, 0.0], fov=45.0, resolution=res, device="cpu")
    return rtt.make_scene(cam, shapes, mats, envmap=envmap), colors


def test_32_material_scene_routes_every_lane():
    """Every camera ray's fetched diffuse equals its material's colour, and
    all 32 materials are seen (the port has no diffuse AOV channel yet, so
    the primary hits are fetched directly)."""
    scene, colors = _grid_scene(M=32, textured=(5, 17, 30))
    fs = flatten_scene(scene)
    cam = scene.camera
    with torch.no_grad():
        ray, rd = sample_primary_rays(
            cam, torch.full((cam.width * cam.height, 2), 0.5))
        isect = taccel.intersect(fs, ray)
        sp, _ = _surface_point_at(fs, isect, ray, rd)
        mid = fs.face_material_id[torch.clamp(isect.tri_id, 0)]
        lm = fetch_local_material(fs, sp, mid)
    hit = isect.valid.numpy()
    assert hit.sum() > 0.3 * hit.size
    alb = lm.diffuse.numpy()[hit]
    d = np.linalg.norm(alb[:, None, :] - colors[None, :, :], axis=-1)
    assert d.min(axis=1).max() < 1e-3
    np.testing.assert_array_equal(d.argmin(axis=1), mid.numpy()[hit])
    assert len(np.unique(d.argmin(axis=1))) == 32


def test_bank_gradient_flows_to_right_material_only():
    """Under a constant envmap the textured material's texels and a
    constant material get gradients; weighting the textured quad's pixels
    to zero zeroes its texel gradient (no cross-talk through the bank)."""
    env = rtt.make_environment_map(np.ones((4, 8, 3), np.float32),
                                   device="cpu")
    scene, _ = _grid_scene(M=8, res=(32, 32), textured=(3,), envmap=env)
    opts = rtt.RenderOptions(num_samples=1, max_bounces=1,
                             sample_pixel_center=True)
    fs = flatten_scene(scene)
    cam = scene.camera
    with torch.no_grad():
        ray, _ = sample_primary_rays(
            cam, torch.full((cam.width * cam.height, 2), 0.5))
        mid = fs.face_material_id[torch.clamp(taccel.intersect(fs, ray).tri_id,
                                              0)]
        on3 = (mid == 3) & taccel.intersect(fs, ray).valid
    mask = (~on3).to(torch.float32).reshape(cam.height, cam.width, 1)
    t3 = scene.materials[3].diffuse_reflectance.texels
    t0 = scene.materials[0].diffuse_reflectance.texels
    for weight, want3 in ((torch.ones_like(mask), True), (mask, False)):
        t3.requires_grad_(True)
        t0.requires_grad_(True)
        img = rtt.render_image(scene, opts, seed=0)
        g3, g0 = torch.autograd.grad(torch.sum(img * weight), [t3, t0])
        assert g3.shape == (8, 8, 3)
        assert bool(torch.isfinite(g3).all()) and float(g0.abs().sum()) > 0
        assert (float(g3.abs().sum()) > 0) == want3
    t3.requires_grad_(False)
    t0.requires_grad_(False)


# ------------------------------------------------------------ the scene


def _textured_quad_scene(res=(8, 8)):
    """A quad with a 13x7 diffuse texture (non-power-of-two, non-divisible
    mip levels), a roughness texture and a normal map, an area light above
    it and a rotated gradient envmap behind it."""
    rng = np.random.default_rng(SEED)
    cam = rt.make_camera(position=[0.0, 0.4, -4.0], look_at=[0.0, 0.0, 0.0],
                         up=[0.0, 1.0, 0.0], fov=45.0, resolution=res)
    quad = rt.make_shape(
        vertices=[[-1.3, -1.2, 0.1], [1.2, -1.3, 0.0], [-1.2, 1.3, 0.0],
                  [1.3, 1.2, -0.1]],
        indices=[[0, 2, 1], [1, 2, 3]],
        uvs=[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]], material_id=0)
    light = rt.generate_quad_light(position=[0.0, 2.5, -1.5],
                                   look_at=[0.0, 0.0, 0.0], size=[1.0, 1.0],
                                   intensity=[8.0, 8.0, 8.0])
    lshape = rt.make_shape(vertices=light.vertices, indices=light.indices,
                           material_id=1, light_id=0)
    nmap = np.concatenate([0.5 + 0.15 * rng.uniform(-1, 1, (8, 8, 2)),
                           np.ones((8, 8, 1))], axis=-1).astype(np.float32)
    mat = rt.make_material(
        diffuse_reflectance=rng.uniform(0.2, 0.8, (13, 7, 3)).astype(
            np.float32),
        specular_reflectance=np.asarray([0.15, 0.15, 0.15], np.float32),
        roughness=rng.uniform(0.2, 0.6, (4, 4, 1)).astype(np.float32),
        normal_map=rt.make_texture(nmap))
    black = rt.make_material(diffuse_reflectance=np.zeros(3, np.float32))
    h, w = 8, 16
    y = np.linspace(0.2, 1.0, h, dtype=np.float32)[:, None, None]
    x = np.linspace(0.3, 0.9, w, dtype=np.float32)[None, :, None]
    values = np.concatenate([y * np.ones((1, w, 1), np.float32),
                             x * np.ones((h, 1, 1), np.float32),
                             0.5 * np.ones((h, w, 1), np.float32)], axis=-1)
    values[2, 5] = 6.0  # a bright spot, so importance sampling matters
    a = np.radians(30.0)
    rot = np.asarray([[np.cos(a), 0, np.sin(a), 0], [0, 1, 0, 0],
                      [-np.sin(a), 0, np.cos(a), 0], [0, 0, 0, 1]],
                     np.float32)
    env = rt.make_environment_map(values, env_to_world=rot)
    return rt.make_scene(cam, [quad, lshape], [mat, black],
                         area_lights=[rt.make_area_light(1, [8.0, 8.0, 8.0])],
                         envmap=env)


def test_scene_leaves_cover_textures_and_envmap():
    """render differentiates scene_leaves: every texture's texels and uv
    scale and the envmap's texels, uv scale and both transforms are
    leaves, in a fixed order (the envmap's last), and scene_with_leaves
    puts replacements back in the same places."""
    from redner_tpu_torch.scene import scene_leaves, scene_with_leaves

    ts = port_scene(_textured_quad_scene(res=(4, 4)))
    leaves = scene_leaves(ts)
    mat, env = ts.materials[0], ts.envmap
    want = [mat.diffuse_reflectance.texels, mat.diffuse_reflectance.uv_scale,
            mat.roughness.texels, mat.normal_map.texels,
            mat.normal_map.uv_scale]
    ids = [id(x) for x in leaves]
    pos = [ids.index(id(x)) for x in want]
    assert pos == sorted(pos)
    assert ids[-4:] == [id(env.values.texels), id(env.values.uv_scale),
                        id(env.env_to_world), id(env.world_to_env)]
    swapped = scene_with_leaves(ts, [x + 1.0 for x in leaves])
    assert torch.equal(swapped.envmap.world_to_env, env.world_to_env + 1.0)
    assert torch.equal(swapped.materials[0].normal_map.texels,
                       mat.normal_map.texels + 1.0)


def test_envtex_scene_builds_on_cpu():
    """chip_smoke's textured, envmap-lit scene through the user path
    (scene_from_objects with an envmap), at a tiny size: the bank holds the
    three sphere stacks, the envmap takes its light slot, and the
    gradient w.r.t. every leaf the script differentiates is finite."""
    from chip_smoke import ENVTEX_LEAVES, envtex_gradient, make_envtex_scene

    scene = make_envtex_scene(res=(8, 8), theta=8, phi=16, tex=16,
                              env=(8, 16), device="cpu")
    fs = flatten_scene(scene)
    assert fs.num_triangles == 15 * 12 + 4 and fs.num_lights == 2
    assert fs.mat_bank_pos == (0, -1, 1, 2) and fs.mat_bank.Lmax == 5
    grads = envtex_gradient(scene, rtt.RenderOptions(num_samples=1))
    assert len(grads) == len(ENVTEX_LEAVES)
    for g in grads:
        assert bool(torch.isfinite(g).all())
