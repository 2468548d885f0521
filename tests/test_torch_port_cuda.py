"""redner_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card.  Skipped without CUDA: the kernels have no CPU mode.

render and render_image replay cached CUDA graphs on the card
(redner_tpu_torch.graphs): a test that counts the kernels of a render
counts them at capture (_captured_launches: the kernel nodes the forward
and backward graphs hold), or runs make_render's eager function.

This file imports neither JAX nor redner_tpu, so it also runs where JAX is
not installed; there, skip the repository's conftest (which pins JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import dataclasses
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import redner_tpu_torch as rtt
from redner_tpu_torch import accel, graphs
from redner_tpu_torch.core.types import Ray
from redner_tpu_torch.ops import intersect as plain
from redner_tpu_torch.ops import intersect_cuda as ic


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ray-query kernels have no CPU mode")
    return torch.device("cuda")


def _scene(dev, theta=36, phi=72, res=(32, 32)):
    v, f, uv, n = rtt.generate_sphere(theta, phi, device=dev)
    cam = rtt.make_camera(position=[0.0, 1.5, -4.0], look_at=[0.0, 0.0, 0.0],
                          up=[0.0, 1.0, 0.0], fov=45.0, resolution=res,
                          device=dev)
    mat = rtt.make_material(diffuse_reflectance=[0.5, 0.5, 0.5],
                            specular_reflectance=[0.2, 0.2, 0.2],
                            roughness=[0.05], device=dev)
    floor = rtt.Object(vertices=[[-4.0, -1.0, -4.0], [4.0, -1.0, -4.0],
                                 [-4.0, -1.0, 4.0], [4.0, -1.0, 4.0]],
                       indices=[[0, 2, 1], [1, 2, 3]], material=mat)
    light = rtt.generate_quad_light([0.0, 3.0, -1.0], [0.0, 0.0, 0.0],
                                    [1.5, 1.5], [20.0, 20.0, 20.0], device=dev)
    return rtt.scene_from_objects(cam, [
        rtt.Object(vertices=v, indices=f, uvs=uv, normals=n, material=mat),
        floor, light])


def _rays(dev, n, seed, on=None):
    rng = np.random.default_rng(seed)
    org = rng.normal(0, 3, (n, 3)).astype(np.float32) if on is None else on
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:5] = 0.0  # dead lanes
    t = lambda x: torch.as_tensor(x, device=dev)
    tmax = rng.uniform(0.5, 8.0, n).astype(np.float32)
    tmax[5:n // 2] = np.inf
    return Ray(org=t(org), dir=t(d), tmin=t(np.full(n, 1e-3, np.float32)),
               tmax=t(tmax))


@pytest.mark.cuda
@pytest.mark.parametrize("presorted", [False, True])
def test_kernels_match_plain(dev, presorted):
    fs = rtt.flatten_scene(_scene(dev))
    assert fs.layout.nchunks > ic.SORT_MIN_CHUNKS
    ray = _rays(dev, 3001, seed=1)  # not a multiple of the tile
    ic.reset_launch_counts()
    k = accel.intersect(fs, ray, presorted=presorted)
    o = accel.occluded(fs, ray, presorted=presorted)
    assert ic.LAUNCHES == {"closest_hit": 1, "any_hit": 1}
    p = accel.intersect(fs, ray, presorted=presorted, engine="plain")
    po = accel.occluded(fs, ray, presorted=presorted, engine="plain")
    assert ic.LAUNCHES == {"closest_hit": 1, "any_hit": 1}
    assert int(k.valid.sum()) > 100
    assert int((k.tri_id != p.tri_id).sum()) <= 1
    same = (k.tri_id == p.tri_id) & k.valid
    torch.testing.assert_close(k.t[same], p.t[same], rtol=1e-5, atol=0.0)
    assert int((o != po).sum()) <= 1
    assert not k.valid[:5].any() and not o[:5].any()


def _assert_raw_match(lay, rb):
    """Kernel outputs on batch rb equal the plain versions' exactly."""
    best_t, best_i = ic.closest_hit(lay, rb)
    pt, pi = plain.closest_plain(lay.Tc, rb)
    assert torch.equal(best_i.to(torch.int64), pi)
    assert torch.equal(best_t, pt)
    blocked = ic.any_hit(lay, rb)
    pb, _ = plain.anyhit_plain(lay.Tc, rb)
    assert torch.equal(blocked != 0, pb)
    return best_t, best_i, blocked


@pytest.mark.cuda
def test_any_hit_settle_points_match_plain(dev):
    """Settling is order-free: blocked (and the closest hits) equal the
    plain versions' lane for lane."""
    fs = rtt.flatten_scene(_scene(dev))
    rb = ic.prepare_rays(fs, _rays(dev, 4096, seed=2))
    _assert_raw_match(fs.layout, rb)


@pytest.mark.cuda
def test_inactive_tiles_miss(dev):
    """No active (tile, chunk) pair: one launch each that does no work (the
    count on the device is 0), and every lane misses."""
    fs = rtt.flatten_scene(_scene(dev))
    n = 300
    ray = Ray(org=torch.tensor([0.0, 0.0, -50.0], device=dev).expand(n, 3),
              dir=torch.tensor([0.0, 0.0, -1.0], device=dev).expand(n, 3),
              tmin=torch.full((n,), 1e-3, device=dev),
              tmax=torch.full((n,), float("inf"), device=dev))
    rb = ic.prepare_rays(fs, ray)
    assert not rb.tile_active.any() and int(rb.count) == 0
    assert rb.pairs.shape[0] == rb.mask.numel()
    ic.reset_launch_counts()
    best_t, best_i = ic.closest_hit(fs.layout, rb)
    assert torch.isinf(best_t).all() and (best_i == -1).all()
    assert not ic.any_hit(fs.layout, rb).any()
    assert ic.LAUNCHES == {"closest_hit": 1, "any_hit": 1}


# Scenes built straight from vertex arrays, for batches whose work list is
# known (the CPU tests in test_torch_port_kernel_layout.py check that).


def _layout_of(vertices, faces, device):
    fs = SimpleNamespace(
        vertices=torch.as_tensor(np.asarray(vertices, np.float32), device=device),
        faces=torch.as_tensor(np.asarray(faces, np.int64), device=device))
    fs.layout = ic.coeff_layout_build(fs)
    return fs


def grid_plane(device, n=64):
    """An n x n grid of unit quads (2 n^2 triangles) at y = 0 over
    [0, n]^2.  Morton order makes each 512-triangle chunk a 16 x 16-cell
    block, so the chunk AABBs only touch at their borders."""
    i, k = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    v = np.stack([i, np.zeros_like(i), k], -1).reshape(-1, 3)
    a = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]).reshape(-1)
    faces = np.concatenate([np.stack([a, a + 1, a + n + 1], -1),
                            np.stack([a + 1, a + n + 2, a + n + 1], -1)])
    return _layout_of(v, faces, device)


def unbalanced_rays(device, seed=0, ntile=40):
    """Rays down onto grid_plane, one 128-ray tile after another: tile 0
    covers all 16 blocks (every chunk active), tile 1 points up (no chunk),
    every other tile lands in one block (one chunk).  Half the lanes stop
    short of the plane, so no any-hit tile settles early."""
    rng = np.random.default_rng(seed)
    n = ntile * 128
    block = np.concatenate([np.arange(128) % 16,
                            np.zeros(128, np.int64),
                            np.repeat(rng.integers(0, 16, ntile - 2), 128)])
    xz = 16.0 * np.stack([block // 4, block % 4], -1) + rng.uniform(1, 15, (n, 2))
    org = np.stack([xz[:, 0], np.ones(n), xz[:, 1]], -1).astype(np.float32)
    d = np.tile(np.float32([0.0, -1.0, 0.0]), (n, 1))
    d[128:256, 1] = 1.0
    tmax = np.where(np.arange(n) // 16 % 2, 0.5, 2.0).astype(np.float32)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return Ray(org=t(org), dir=t(d), tmin=t(np.full(n, 1e-3)), tmax=t(tmax))


def tie_scene(device, fillers=600):
    """Triangle A, `fillers` degenerate triangles at A's centroid, then a
    copy of A.  All centroids coincide, so the Morton sort keeps this
    order: A is sorted slot 0 (chunk 0), its copy slot fillers + 1
    (chunk 1), and every ray that hits one hits both at the same t."""
    a = np.float32([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    c = a.mean(axis=0)
    v = np.concatenate([a, np.tile(c, (3 * fillers, 1)), a])
    f = np.concatenate([[[0, 1, 2]],
                        np.arange(3, 3 + 3 * fillers).reshape(-1, 3),
                        [[3 * fillers + 3, 3 * fillers + 4, 3 * fillers + 5]]])
    return _layout_of(v, f, device)


def tie_rays(device, n=1000, seed=0):
    rng = np.random.default_rng(seed)
    xz = rng.uniform(0.02, 0.48, (n, 2))
    org = np.stack([xz[:, 0], np.full(n, 2.0), xz[:, 1]], -1)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return Ray(org=t(org), dir=t(np.tile([0.0, -1.0, 0.0], (n, 1))),
               tmin=t(np.full(n, 1e-3)), tmax=t(np.full(n, 10.0)))


@pytest.mark.cuda
def test_unbalanced_work_matches_plain(dev):
    """One tile's list holds every chunk, the others one or none."""
    fs = grid_plane(dev)
    rb = ic.prepare_rays(fs, unbalanced_rays(dev), presorted=True)
    active = rb.mask.sum(dim=1)
    assert int(active[0]) == fs.layout.nchunks and int(active[1]) == 0
    assert (active[2:] == 1).all()
    best_t, best_i, blocked = _assert_raw_match(fs.layout, rb)
    assert 0 < int((best_i >= 0).sum()) < rb.n
    assert torch.equal(blocked != 0, best_i >= 0)


@pytest.mark.cuda
def test_exact_ties_take_lower_index(dev):
    """Coincident triangles in two chunks: the lower sorted index wins."""
    fs = tie_scene(dev)
    rb = ic.prepare_rays(fs, tie_rays(dev), presorted=True)
    assert rb.mask.all()
    best_t, best_i, _ = _assert_raw_match(fs.layout, rb)
    live = torch.arange(best_i.shape[0], device=dev) < rb.n
    assert (best_i[live] == 0).all() and (best_t[live] == 2.0).all()


def _captured_launches(run):
    """run() twice on an empty graph cache (the first call runs eagerly,
    the second captures) -> (the second's result, the kernel launches its
    forward and backward captures recorded): the kernel nodes of one
    graphed forward, or of one graphed gradient."""
    graphs.clear()
    run()
    before = dict(graphs.CAPTURES)
    out = run()
    got = {k: 0 for k in ic.LAUNCHES}
    for kind in ("forward", "backward"):
        if graphs.CAPTURES[kind] > before[kind]:
            for k, v in graphs.LAST_CAPTURE[kind]["launches"].items():
                got[k] += v
    return out, got


def _render_grads(scene, opts, seed, weight, engine=None):
    """The image of render and the gradients of sum(image * weight) w.r.t.
    the first material's diffuse reflectance, the light intensity, every
    shape's vertices and the camera position."""
    leaves = ([scene.materials[0].diffuse_reflectance.texels,
               scene.area_lights[0].intensity]
              + [s.vertices for s in scene.shapes] + [scene.camera.position])
    for x in leaves:
        x.requires_grad_(True)
    img = rtt.render(scene, opts, seed=seed, engine=engine)
    grads = torch.autograd.grad(
        torch.sum(img * torch.as_tensor(weight, device=img.device)), leaves)
    return img.detach(), [g.cpu().numpy() for g in grads]


@pytest.mark.cuda
def test_render_gradient_matches_plain(dev):
    """The edge-sampled gradient through the kernels equals the one through
    the plain queries up to the order of the gradient's scatter-adds, and
    the kernels launch on every ray batch: one pass of 512 lanes (2 closest
    hit + 1 any hit) in the forward, the re-render and the secondary pairs,
    and one chunk of primary-edge pairs."""
    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    w = np.random.default_rng(4).uniform(0.5, 1.5, (16, 16, 3)).astype(
        np.float32)
    (img, grads), launches = _captured_launches(
        lambda: _render_grads(_scene(dev, res=(16, 16)), opts, 5, w))
    assert launches == {"closest_hit": 8, "any_hit": 4}
    (img_p, grads_p), launches = _captured_launches(
        lambda: _render_grads(_scene(dev, res=(16, 16)), opts, 5, w,
                              engine="plain"))
    assert launches == {"closest_hit": 0, "any_hit": 0}
    assert torch.equal(img, img_p)
    assert np.abs(grads[2]).max() > 0  # the sphere's vertices
    for g, gp in zip(grads, grads_p):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, gp, rtol=1e-4,
                                   atol=1e-6 * np.abs(gp).max())


@pytest.mark.cuda
def test_render_matches_cpu(dev):
    opts = rtt.RenderOptions(num_samples=2, max_bounces=2)
    img, launches = _captured_launches(
        lambda: rtt.render_image(_scene(dev, res=(16, 16)), opts, seed=5))
    img = img.cpu()
    assert launches == {"closest_hit": 3, "any_hit": 2}
    ref = rtt.render_image(_scene("cpu", res=(16, 16)), opts, seed=5)
    close = torch.isclose(img, ref, rtol=1e-4, atol=1e-6 * float(ref.max()))
    assert int((~close.all(-1)).sum()) <= 2


@pytest.mark.cuda
def test_any_hit_infinite_tmax_from_surface_points(dev):
    """Envmap shadow rays: from points on the scene's triangles, to
    tmax = inf (the any-hit kernel's only infinite segments); the kernels
    equal the plain versions lane for lane."""
    fs = rtt.flatten_scene(_scene(dev))
    rng = np.random.default_rng(6)
    n = 5000
    faces = fs.faces.cpu().numpy()
    verts = fs.vertices.detach().cpu().numpy()
    tri = rng.integers(0, faces.shape[0], n)
    b = rng.dirichlet([1.0, 1.0, 1.0], n).astype(np.float32)
    on = (b[:, :1] * verts[faces[tri, 0]] + b[:, 1:2] * verts[faces[tri, 1]]
          + b[:, 2:3] * verts[faces[tri, 2]]).astype(np.float32)
    ray = _rays(dev, n, seed=7, on=on)
    ray.tmax = torch.full((n,), float("inf"), device=dev)
    rb = ic.prepare_rays(fs, ray)
    _, _, blocked = _assert_raw_match(fs.layout, rb)
    assert 0 < int((blocked != 0).sum()) < rb.n


@pytest.mark.cuda
def test_textured_envmap_render_gradient_matches_plain(dev):
    """A textured, normal-mapped sphere under an envmap and an area light:
    the edge-sampled gradient through the kernels equals the one through
    the plain queries up to the order of the gradient's scatter-adds."""
    from chip_smoke import envtex_gradient, make_envtex_scene

    kw = dict(res=(16, 16), theta=16, phi=32, tex=64, env=(32, 64))
    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    got, launches = _captured_launches(
        lambda: envtex_gradient(make_envtex_scene(device=dev, **kw), opts))
    assert launches == {"closest_hit": 8, "any_hit": 4}
    ref, launches = _captured_launches(
        lambda: envtex_gradient(make_envtex_scene(device=dev, **kw), opts,
                                engine="plain"))
    assert launches == {"closest_hit": 0, "any_hit": 0}
    for g, r in zip(got, ref):
        g, r = g.cpu().numpy(), r.cpu().numpy()
        assert np.isfinite(g).all() and np.abs(r).max() > 0
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6 * np.abs(r).max())


_AOV_KW = dict(res=(16, 16), theta=16, phi=32, tex=64, env=(32, 64),
               generic=16)


@pytest.mark.cuda
def test_gbuffer_gradient_matches_plain(dev):
    """render_g_buffer with all 16 channels (Sobol, 0 bounces): its
    full-channel gradient through the kernels equals the one through the
    plain queries up to the order of the scatter-adds; the forward, the
    re-render and the one chunk of primary-edge pairs are one closest-hit
    launch each, and no any-hit launch runs without radiance."""
    from chip_smoke import aov_render, make_envtex_scene

    (img, got), launches = _captured_launches(
        lambda: aov_render("g_buffer",
                           make_envtex_scene(device=dev, **_AOV_KW),
                           grad=True))
    assert launches == {"closest_hit": 3, "any_hit": 0}
    (img_p, ref), launches = _captured_launches(
        lambda: aov_render("g_buffer",
                           make_envtex_scene(device=dev, **_AOV_KW),
                           engine="plain", grad=True))
    assert launches == {"closest_hit": 0, "any_hit": 0}
    assert img.shape == (16, 16, 47) and torch.equal(img, img_p)
    for g, r in zip(got, ref):
        g, r = g.cpu().numpy(), r.cpu().numpy()
        assert np.isfinite(g).all() and np.abs(r).max() > 0
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6 * np.abs(r).max())


@pytest.mark.cuda
def test_deferred_matches_cpu(dev):
    """render_deferred (four lights, alpha, 2x2 supersampling) on the card
    against the CPU: the image on all but 1% of the pixels at rtol 1e-4,
    the gradients within relative L2 0.05."""
    from chip_smoke import aov_render, make_envtex_scene

    img, got = aov_render("deferred", make_envtex_scene(device=dev, **_AOV_KW),
                          grad=True)
    ref, want = aov_render("deferred",
                           make_envtex_scene(device="cpu", **_AOV_KW),
                           grad=True)
    assert img.shape == (16, 16, 4)
    close = torch.isclose(img.cpu(), ref, rtol=1e-4,
                          atol=1e-6 * float(ref.abs().max())).all(-1)
    assert int((~close).sum()) <= 0.01 * close.numel()
    for g, r in zip(got, want):
        assert torch.isfinite(g).all() and r.abs().max() > 0
        assert float((g.cpu() - r).norm() / r.norm()) <= 0.05


@pytest.mark.cuda
def test_sobol_draw_matches_cpu(dev):
    """The Sobol draws on the card equal the CPU's bit for bit (the bit
    matrix product is exact in float32 whatever the summation order)."""
    from redner_tpu_torch import sampler

    rng = np.random.default_rng(8)
    pix = rng.integers(0, 2**32, 100000, dtype=np.uint64).astype(np.int64)
    sid = rng.integers(0, 2**32, 100000, dtype=np.uint64).astype(np.int64)
    for dim, n in ((0, 2), (9, 4), (105, 3), (1020, 7)):
        a = sampler.draw(sampler.SamplerType.sobol, 2**32 - 1,
                         torch.as_tensor(pix, device=dev),
                         torch.as_tensor(sid, device=dev), dim, n)
        b = sampler.draw(sampler.SamplerType.sobol, 2**32 - 1,
                         torch.as_tensor(pix), torch.as_tensor(sid), dim, n)
        assert a.is_cuda and torch.equal(a.cpu(), b)


def _fisheye_scene(dev):
    """_scene under a fisheye camera from the same cam_to_world."""
    from redner_tpu_torch.camera import camera_to_world

    scene = _scene(dev, res=(16, 16))
    cam = rtt.make_camera(
        cam_to_world=camera_to_world(scene.camera).detach().clone(),
        camera_type=rtt.CameraType.fisheye, resolution=(16, 16), device=dev)
    return dataclasses.replace(scene, camera=cam)


@pytest.mark.cuda
def test_fisheye_gradient_matches_plain(dev):
    """The fisheye camera's edge-sampled gradient (the film arc, dead lanes
    outside the image circle) through the kernels equals the one through
    the plain queries, cam_to_world included."""
    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    w = np.random.default_rng(5).uniform(0.5, 1.5, (16, 16, 3)).astype(
        np.float32)

    def grads(engine):
        scene = _fisheye_scene(dev)
        leaves = [scene.shapes[0].vertices, scene.camera.cam_to_world]
        for x in leaves:
            x.requires_grad_(True)
        img = rtt.render(scene, opts, seed=5, engine=engine)
        g = torch.autograd.grad(
            torch.sum(img * torch.as_tensor(w, device=dev)), leaves)
        return img.detach(), [x.cpu().numpy() for x in g]

    (img, g), launches = _captured_launches(lambda: grads(None))
    assert launches == {"closest_hit": 8, "any_hit": 4}
    img_p, g_p = grads("plain")
    assert torch.equal(img, img_p)
    for a, b in zip(g, g_p):
        assert np.isfinite(a).all() and np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * np.abs(b).max())


@pytest.mark.cuda
def test_meshops_builds_into_the_port(dev):
    from redner_tpu_torch import meshops

    path = meshops.build()
    assert path.parent == meshops.BUILD_DIR and path.exists()
    v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 0, 1e-7]],
                   np.float32)
    np.testing.assert_array_equal(meshops.weld_ids(v, 1e-5), [0, 1, 2, 1])


@pytest.mark.cuda
def test_loaded_obj_on_card_equals_cpu_load(dev, tmp_path):
    """An OBJ with uvs, normals and split vertices loads onto the card
    with the same arrays and weld map as onto the CPU."""
    v, f, uv, n = (x.numpy() for x in rtt.generate_sphere(6, 10,
                                                          device="cpu"))
    path = tmp_path / "s.obj"
    with open(path, "w") as out:
        for c in f.reshape(-1):
            out.write(f"v {v[c][0]:.6g} {v[c][1]:.6g} {v[c][2]:.6g}\n"
                      f"vt {uv[c][0]:.6g} {uv[c][1]:.6g}\n"
                      f"vn {n[c][0]:.6g} {n[c][1]:.6g} {n[c][2]:.6g}\n")
        for k in range(f.shape[0]):
            a = 3 * k + 1
            out.write(f"f {a}/{a}/{a} {a + 1}/{a + 1}/{a + 1} "
                      f"{a + 2}/{a + 2}/{a + 2}\n")
    on_card = rtt.load_obj(str(path), return_objects=True, device=dev)[0]
    on_cpu = rtt.load_obj(str(path), return_objects=True, device="cpu")[0]
    assert on_card.weld_ids is not None
    for name in ("vertices", "indices", "uvs", "normals", "weld_ids"):
        a, b = getattr(on_card, name), getattr(on_cpu, name)
        assert a.is_cuda and torch.equal(a.cpu(), b), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode,launches", [
    ("replay", {"closest_hit": 8, "any_hit": 4}),
    ("remat", {"closest_hit": 12, "any_hit": 6}),
])
def test_replay_and_remat_gradients_match_live(dev, mode, launches):
    """isect_replay_max_mb is accepted and changes nothing: the live
    gradient's 8 + 4 launches (one pass of 512 lanes); remat runs the
    re-render and the secondary pairs again (+ 4 + 2).  The gradient is the
    live one up to the order of the gradient's scatter-adds."""
    w = np.random.default_rng(4).uniform(0.5, 1.5, (16, 16, 3)).astype(
        np.float32)
    live = rtt.RenderOptions(num_samples=2, max_bounces=1)
    opts = (rtt.RenderOptions(num_samples=2, max_bounces=1,
                              isect_replay_max_mb=64.0) if mode == "replay"
            else rtt.RenderOptions(num_samples=2, max_bounces=1, remat=True))
    img, grads = _render_grads(_scene(dev, res=(16, 16)), live, 5, w)
    (img_m, grads_m), got = _captured_launches(
        lambda: _render_grads(_scene(dev, res=(16, 16)), opts, 5, w))
    assert got == launches
    assert torch.equal(img_m, img)
    for g, gm in zip(grads, grads_m):
        assert np.isfinite(gm).all()
        np.testing.assert_allclose(gm, g, rtol=1e-4,
                                   atol=1e-6 * np.abs(g).max())


@pytest.mark.cuda
def test_frontend_renders_on_the_card(dev):
    """redner_tpu_torch.frontend defaults to the card: its objects land
    there, its render launches the kernels, and its image and gradients
    equal the functional render of the same scene."""
    import redner_tpu_torch.frontend as pyredner

    rtt.set_device(None)
    cam = pyredner.Camera(position=[0.0, 1.5, -4.0], look_at=[0.0, 0.0, 0.0],
                          up=[0.0, 1.0, 0.0], fov=[45.0], resolution=(16, 16))
    v, f, uv, n = pyredner.generate_sphere(36, 72)
    mat = pyredner.Material(diffuse_reflectance=[0.5, 0.5, 0.5],
                            specular_reflectance=[0.2, 0.2, 0.2],
                            roughness=[0.05])
    light = pyredner.generate_quad_light([0.0, 3.0, -1.0], [0.0, 0.0, 0.0],
                                         [1.5, 1.5], [20.0, 20.0, 20.0])
    floor = pyredner.Object(vertices=[[-4.0, -1.0, -4.0], [4.0, -1.0, -4.0],
                                      [-4.0, -1.0, 4.0], [4.0, -1.0, 4.0]],
                            indices=[[0, 2, 1], [1, 2, 3]], material=mat)
    scene = pyredner.Scene(camera=cam, objects=[
        pyredner.Object(vertices=v, indices=f, uvs=uv, normals=n,
                        material=mat), floor, light])
    assert scene.shapes[0].vertices.is_cuda
    verts = scene.shapes[0].vertices.requires_grad_(True)

    def run():
        verts.grad = None  # _captured_launches calls run twice
        img = pyredner.render(scene, num_samples=2, max_bounces=1, seed=5)
        img.sum().backward()
        return img

    img, launches = _captured_launches(run)
    assert launches == {"closest_hit": 8, "any_hit": 4}
    ref_scene = _scene(dev, res=(16, 16))
    ref_verts = ref_scene.shapes[0].vertices.requires_grad_(True)
    ref = rtt.render(ref_scene, rtt.RenderOptions(num_samples=2,
                                                  max_bounces=1), seed=5)
    ref.sum().backward()
    assert torch.equal(img.detach(), ref.detach())
    g, r = verts.grad.cpu().numpy(), ref_verts.grad.cpu().numpy()
    np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6 * np.abs(r).max())


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["bruteforce", "cluster"])
def test_engines_match_the_kernels(dev, engine):
    """The bruteforce and cluster names (the plain queries on CUDA
    tensors) return the kernels' hits and occlusion, and launch no
    kernel."""
    scene = _scene(dev)
    fs = rtt.flatten_scene(scene)
    on = fs.vertices[fs.faces[:, 0]][:2048].detach().cpu().numpy()
    for ray in (_rays(dev, 4096, 11), _rays(dev, 2048, 12, on=on)):
        k = accel.intersect(fs, ray)
        ko = accel.occluded(fs, ray)
        ic.reset_launch_counts()
        x = accel.intersect(fs, ray, engine=engine)
        xo = accel.occluded(fs, ray, engine=engine)
        assert ic.LAUNCHES == {"closest_hit": 0, "any_hit": 0}
        assert x.tri_id.is_cuda and xo.is_cuda
        assert torch.equal(x.tri_id, k.tri_id)
        assert torch.equal(xo, ko)
        hit = k.valid
        assert int(hit.sum()) > 100
        torch.testing.assert_close(x.t[hit], k.t[hit], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
def test_one_rank_nccl_render_matches_one_process(dev, tmp_path):
    """render_sharded over a one-rank NCCL group: the collectives run and
    the image and gradients are the one-process ones."""
    import torch.distributed as dist

    from redner_tpu_torch.parallel.sharding import make_mesh, render_sharded

    w = np.random.default_rng(6).uniform(0.5, 1.5, (16, 16, 3)).astype(
        np.float32)
    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    img, grads = _render_grads(_scene(dev, res=(16, 16)), opts, 5, w)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(dev)
        scene = _scene(dev, res=(16, 16))
        leaves = ([scene.materials[0].diffuse_reflectance.texels,
                   scene.area_lights[0].intensity]
                  + [s.vertices for s in scene.shapes]
                  + [scene.camera.position])
        for x in leaves:
            x.requires_grad_(True)
        img_s = render_sharded(scene, opts, seed=5, mesh=mesh)
        grads_s = torch.autograd.grad(
            torch.sum(img_s * torch.as_tensor(w, device=dev)), leaves)
    finally:
        dist.destroy_process_group()
    assert mesh.world == 1 and mesh.group is not None
    torch.testing.assert_close(img_s.detach(), img, rtol=0, atol=1e-6)
    for g, gs in zip(grads, grads_s):
        np.testing.assert_allclose(gs.cpu().numpy(), g, rtol=1e-4,
                                   atol=1e-6 * np.abs(g).max())


# ------------------------------------------------------ the compiled render


def _leaf_grads(render, scene, seed, weight):
    """render(scene, seed)'s image and the gradients of sum(image *
    weight) w.r.t. the sphere's vertices, the diffuse and the light."""
    leaves = [scene.shapes[0].vertices,
              scene.materials[0].diffuse_reflectance.texels,
              scene.area_lights[0].intensity]
    for x in leaves:
        x.requires_grad_(True)
    try:
        img = render(scene, seed)
        grads = torch.autograd.grad(
            torch.sum(img * torch.as_tensor(weight, device=img.device)),
            leaves)
    finally:
        for x in leaves:
            x.requires_grad_(False)
    return img.detach(), [g.detach() for g in grads]


@pytest.mark.cuda
def test_graphed_render_matches_eager(dev):
    """At 32x32 the graphed render's image is the eager one's (atol 1e-6 on
    every pixel) and its gradients agree up to the order of the index
    backward's atomics (rtol 1e-4, atol 1e-6 x max), at two seeds and
    after an in-place update of the vertices, which the next replay
    reads."""
    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    eager = rtt.make_render(opts)
    scene = _scene(dev, res=(32, 32))
    w = np.random.default_rng(9).uniform(0.5, 1.5, (32, 32, 3)).astype(
        np.float32)
    graphs.clear()
    for step, seed in enumerate((5, 6, 6)):
        if step == 2:
            with torch.no_grad():
                scene.shapes[0].vertices.mul_(1.05)
        img, got = _leaf_grads(
            lambda s, sd: rtt.render(s, opts, seed=sd), scene, seed, w)
        ref_img, ref = _leaf_grads(eager, scene, seed, w)
        torch.testing.assert_close(img, ref_img, rtol=0, atol=1e-6)
        for g, r in zip(got, ref):
            g, r = g.cpu().numpy(), r.cpu().numpy()
            assert np.isfinite(g).all() and np.abs(r).max() > 0
            np.testing.assert_allclose(g, r, rtol=1e-4,
                                       atol=1e-6 * np.abs(r).max())
    assert len(graphs._cache) == 1


@pytest.mark.cuda
def test_graphed_results_are_copies_and_one_capture_per_key(dev):
    """A result kept from call 1 is unchanged after call 2 (another seed);
    one key runs eagerly at its first call, captures one forward and one
    backward graph at its second, and every call from the second on
    replays them."""
    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    scene = _scene(dev, res=(16, 16))
    w = np.ones((16, 16, 3), np.float32)
    graphs.clear()
    captures, replays = dict(graphs.CAPTURES), dict(graphs.REPLAYS)
    render = lambda s, sd: rtt.render(s, opts, seed=sd)
    img1, g1 = _leaf_grads(render, scene, 5, w)
    keep_img, keep_g = img1.clone(), [g.clone() for g in g1]
    img2, g2 = _leaf_grads(render, scene, 6, w)
    _leaf_grads(render, scene, 7, w)
    assert not torch.equal(img1, img2)
    assert torch.equal(img1, keep_img)
    assert all(torch.equal(a, b) for a, b in zip(g1, keep_g))
    assert {k: graphs.CAPTURES[k] - captures[k] for k in captures} == {
        "forward": 1, "backward": 1}
    assert {k: graphs.REPLAYS[k] - replays[k] for k in replays} == {
        "forward": 2, "backward": 2}


@pytest.mark.cuda
def test_other_indices_replay_as_their_own_scene(dev):
    """A scene of the same shapes whose light faces the other way (its
    indices' winding flipped) shares the key and renders its own image:
    the integer arrays are inputs of the graph, not baked into it."""
    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    scene = _scene(dev, res=(16, 16))
    light = scene.shapes[2]
    flipped = dataclasses.replace(scene, shapes=scene.shapes[:2] + (
        dataclasses.replace(light, indices=light.indices.flip(1)),))
    graphs.clear()
    with torch.no_grad():
        a = rtt.render(scene, opts, seed=5)
        b = rtt.render(flipped, opts, seed=5)
        ref_b = rtt.make_render(opts)(flipped, 5)
    assert len(graphs._cache) == 1
    assert not torch.allclose(a, b)
    torch.testing.assert_close(b, ref_b, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_graph_cache_evicts_the_least_recent_key(dev):
    """The cache holds CACHE_SIZE keys: one more evicts the least recently
    used, which runs eagerly and captures again when it comes back."""
    scene = _scene(dev, res=(16, 16))
    graphs.clear()
    keys = [rtt.RenderOptions(num_samples=n, max_bounces=0)
            for n in range(1, graphs.CACHE_SIZE + 2)]
    with torch.no_grad():
        for opts in keys:
            rtt.render_image(scene, opts, seed=1)
            rtt.render_image(scene, opts, seed=1)
        assert len(graphs._cache) == graphs.CACHE_SIZE
        before = graphs.CAPTURES["forward"]
        rtt.render_image(scene, keys[-1], seed=2)  # cached: a replay
        assert graphs.CAPTURES["forward"] == before
        rtt.render_image(scene, keys[0], seed=1)  # evicted: eager again
        assert graphs.CAPTURES["forward"] == before
        rtt.render_image(scene, keys[0], seed=1)  # and captured
        assert graphs.CAPTURES["forward"] == before + 1


# ------------------------------------------- the routes compiled since then


def _graphed_vs_eager(render, scene, w, seeds=(5, 6, 6), clear=True):
    """render(scene, seed) graphed against the same call inside
    graphs.disable(), at each seed (the last after the vertices x 1.05 in
    place): the image within atol 1e-6 on every pixel, each gradient of
    sum(image * w) within rtol 1e-4 (atol 1e-6 x max).  Returns the
    captures the calls made and whether the first call's results were
    left as they were by the later calls (fresh tensors).  clear: empty
    the graph cache first."""
    if clear:
        graphs.clear()
    before = dict(graphs.CAPTURES)
    kept = None
    for step, seed in enumerate(seeds):
        if step == 2:
            with torch.no_grad():
                scene.shapes[0].vertices.mul_(1.05)
        img, got = _leaf_grads(render, scene, seed, w)
        with graphs.disable():
            ref_img, ref = _leaf_grads(render, scene, seed, w)
        torch.testing.assert_close(img, ref_img, rtol=0, atol=1e-6)
        for g, r in zip(got, ref):
            g, r = g.cpu().numpy(), r.cpu().numpy()
            assert np.isfinite(g).all() and np.abs(r).max() > 0
            np.testing.assert_allclose(g, r, rtol=1e-4,
                                       atol=1e-6 * np.abs(r).max())
        if kept is None:
            kept = (img, got, img.clone(), [g.clone() for g in got])
    fresh = (torch.equal(kept[0], kept[2])
             and all(torch.equal(a, b) for a, b in zip(kept[1], kept[3])))
    return {k: graphs.CAPTURES[k] - before[k] for k in before}, fresh


@pytest.mark.cuda
def test_graphed_render_image_gradient_matches_eager(dev):
    """render_image under autograd replays a forward and a backward graph
    (one capture each for the key, none on later calls) and gives the
    eager image and continuous gradients, fresh tensors every call, and a
    new image after an in-place update of the vertices."""
    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    w = np.random.default_rng(9).uniform(0.5, 1.5, (32, 32, 3)).astype(
        np.float32)
    captures, fresh = _graphed_vs_eager(
        lambda s, sd: rtt.render_image(s, opts, seed=sd),
        _scene(dev, res=(32, 32)), w)
    assert captures == {"forward": 1, "backward": 1} and fresh
    assert len(graphs._cache) == 1


@pytest.mark.cuda
def test_graphed_screen_gradient_matches_eager(dev):
    """screen_gradient_image replays one forward graph per key: within
    relative L2 1e-4 of the eager image (its primary-edge scatter sums with
    atomics), at two seeds and after an in-place update of the vertices;
    a kept result is left as it was."""
    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    scene = _scene(dev, res=(32, 32))
    graphs.clear()
    before = dict(graphs.CAPTURES)
    first = None
    for step, seed in enumerate((5, 6, 6)):
        if step == 2:
            with torch.no_grad():
                scene.shapes[0].vertices.mul_(1.05)
        got = rtt.screen_gradient_image(scene, opts, seed=seed)
        with graphs.disable():
            ref = rtt.screen_gradient_image(scene, opts, seed=seed)
        assert torch.isfinite(got).all() and float(ref.abs().max()) > 0
        assert float((got - ref).norm() / ref.norm()) <= 1e-4
        if first is None:
            first = (got, got.clone())
    assert torch.equal(*first)
    assert {k: graphs.CAPTURES[k] - before[k] for k in before} == {
        "forward": 1, "backward": 0}


@pytest.mark.cuda
def test_one_rank_nccl_render_sharded_replays_graphs(dev, tmp_path):
    """render_sharded over a one-rank NCCL group replays graphs with the
    collectives captured: the eager route's image and gradients, one
    forward and one backward capture, fresh results.  The key holds the
    group: after it is destroyed, a new group's first call captures anew
    (a replay of the old graphs would use a communicator that is gone)."""
    import torch.distributed as dist

    from redner_tpu_torch.parallel.sharding import make_mesh, render_sharded

    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    w = np.random.default_rng(6).uniform(0.5, 1.5, (16, 16, 3)).astype(
        np.float32)
    graphs.clear()
    for attempt in range(2):
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp_path}/rdv{attempt}", rank=0,
            world_size=1)
        try:
            mesh = make_mesh(dev)
            captures, fresh = _graphed_vs_eager(
                lambda s, sd: render_sharded(s, opts, seed=sd, mesh=mesh),
                _scene(dev, res=(16, 16)), w, clear=False)
        finally:
            dist.destroy_process_group()
        assert captures == {"forward": 1, "backward": 1} and fresh
    # The next lookup drops both groups' programs.
    with torch.no_grad():
        rtt.render(_scene(dev, res=(16, 16)), opts, seed=1)
    assert len(graphs._cache) == 1


# --------------------------------------- second derivatives, bytes in the cache


def _second_order(render, scene, seed):
    """d/dleaves of sum(d sum(render(scene)^2) / d leaves) for the sphere's
    vertices, the diffuse and the light."""
    leaves = [scene.shapes[0].vertices,
              scene.materials[0].diffuse_reflectance.texels,
              scene.area_lights[0].intensity]
    for x in leaves:
        x.requires_grad_(True)
    try:
        img = render(scene, seed)
        g = torch.autograd.grad(torch.sum(img ** 2), leaves,
                                create_graph=True)
        assert all(x.requires_grad for x in g)
        return [x.detach() for x in torch.autograd.grad(
            sum(torch.sum(x) for x in g), leaves)]
    finally:
        for x in leaves:
            x.requires_grad_(False)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["render", "render_image"])
def test_graphed_second_derivative_matches_eager(dev, name):
    """Under create_graph the graphed routes run their backward eagerly on
    the saved tensors (graphs.EAGER["create_graph"]: the recording
    backward and the continuous one of the image, 2 a call), beside a
    forward run eagerly at the first call and replayed at the second:
    the second derivative equals graphs.disable()'s within relative L2
    1e-4."""
    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    fn = getattr(rtt, name)
    render = lambda s, sd: fn(s, opts, seed=sd)
    scene = _scene(dev, res=(32, 32))
    graphs.clear()
    before = graphs.EAGER["create_graph"]
    _second_order(render, scene, 5)
    replays = graphs.REPLAYS["forward"]
    got = _second_order(render, scene, 5)
    assert graphs.REPLAYS["forward"] == replays + 1
    assert graphs.EAGER["create_graph"] - before == 4
    with graphs.disable():
        ref = _second_order(render, scene, 5)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all() and float(r.norm()) > 0
        assert float((g - r).norm() / r.norm()) <= 1e-4


@pytest.mark.cuda
def test_cache_counts_the_bytes_of_its_graphs(dev):
    """A captured program counts the reserved memory its graphs added,
    and cached_bytes reports it."""
    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    scene = _scene(dev, res=(32, 32))
    graphs.clear()
    for _ in range(2):  # eager and measured, then captured
        _leaf_grads(lambda s, sd: rtt.render(s, opts, seed=sd), scene, 5,
                    np.ones((32, 32, 3), np.float32))
    (kept,) = graphs.cached_bytes().values()
    assert kept > 0
    assert kept == sum(graphs.LAST_CAPTURE[k]["bytes"]
                       for k in ("forward", "backward"))


@pytest.mark.cuda
def test_graphed_first_order_after_a_recording_backward(dev):
    """On the graphed route too, only the pass that differentiates a
    recorded gradient takes the continuous backward: a later
    loss.backward() through the same render replays the edge-sampled
    backward graph and equals a plain graphed gradient."""
    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    scene = _scene(dev, res=(32, 32))
    v = scene.shapes[0].vertices
    graphs.clear()
    v.requires_grad_(True)
    try:
        for _ in range(2):  # eager and measured, then captured
            (want,) = torch.autograd.grad(
                torch.sum(rtt.render(scene, opts, seed=5) ** 2), v)
        loss = torch.sum(rtt.render(scene, opts, seed=5) ** 2)
        (g,) = torch.autograd.grad(loss, v, create_graph=True,
                                   retain_graph=True)
        torch.autograd.grad(torch.sum(g), v, retain_graph=True)
        replays = graphs.REPLAYS["backward"]
        loss.backward()
        assert graphs.REPLAYS["backward"] == replays + 1
        torch.testing.assert_close(v.grad, want, rtol=1e-4,
                                   atol=1e-6 * float(want.abs().max()))
    finally:
        v.requires_grad_(False)
        v.grad = None


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["render_sharded", "render_image_sharded"])
def test_one_rank_nccl_second_derivative_matches_one_process(dev, tmp_path,
                                                             name):
    """The second derivative through a sharded entry point over a one-rank
    NCCL group (its collectives differentiated in both passes) equals one
    process's eager one within relative L2 1e-4."""
    import torch.distributed as dist

    from redner_tpu_torch.parallel import sharding

    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    one = rtt.render if name == "render_sharded" else rtt.render_image
    with graphs.disable():
        ref = _second_order(lambda s, sd: one(s, opts, seed=sd),
                            _scene(dev, res=(32, 32)), 5)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh(dev)
        fn = getattr(sharding, name)
        got = _second_order(lambda s, sd: fn(s, opts, seed=sd, mesh=mesh),
                            _scene(dev, res=(32, 32)), 5)
    finally:
        dist.destroy_process_group()
        graphs.clear()
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all() and float(r.norm()) > 0
        assert float((g - r).norm() / r.norm()) <= 1e-4


@pytest.mark.cuda
def test_sampling_table_scan_is_the_same_every_run(dev):
    """vecmath.cumsum on the card: 50 scans of a 2^17-entry table give one
    result, within an ulp of the float64 scan."""
    from redner_tpu_torch.core import vecmath as vm

    w = np.random.default_rng(2).exponential(1.0, 1 << 17)
    pmf = torch.as_tensor(w / w.sum(), dtype=torch.float32, device=dev)
    runs = torch.stack([vm.cumsum(pmf, dim=0) for _ in range(50)])
    assert torch.unique(runs, dim=0).shape[0] == 1
    want = torch.cumsum(pmf.double(), dim=0).float()
    torch.testing.assert_close(runs[0], want, rtol=1.2e-7, atol=0)


# ------------------------------------------------------------- tracing


def _kernels_of(call):
    """Device kernels of call() in a CUDA-only profile (copies and fills,
    which the profiler names differently from one profile to the next, and
    the port's spans, record_functions while tracing, left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from redner_tpu_torch import timing

    torch.cuda.synchronize()  # the previous call's kernels left out
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    spans = {r.name for r in timing.records(clear=True)}
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.name not in spans
            and not e.name.lower().startswith(("memcpy", "memset"))]


@pytest.mark.cuda
def test_captured_phases_time_every_replay(dev):
    """With tracing on a forward graph's phases are event nodes: every
    replay reads a positive `fwd` time and its phases again, and their
    sum stays inside the whole body."""
    from redner_tpu_torch import timing

    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    scene = _scene(dev, res=(32, 32))
    graphs.clear()
    timing.clear()
    timing.set_tracing(True)
    try:
        with torch.no_grad():
            for seed in range(2):  # the eager run, then the capture
                rtt.render_image(scene, opts, seed=seed)
            timing.records(clear=True)
            for seed in range(2, 5):
                rtt.render_image(scene, opts, seed=seed)
                recs = timing.records(clear=True)
                body = [r for r in recs if r.name == "fwd"]
                assert len(body) == 1 and body[0].device > 0
                assert body[0].start is None
                parts = [r for r in recs if r.parent == body[0].id]
                assert {"camera", "isect.closest", "isect.any",
                        "shade.surface", "fwd.other"} <= {
                            r.name for r in parts}
                assert sum(r.device for r in parts) == pytest.approx(
                    body[0].device)
                assert all(r.device >= 0 for r in parts)
    finally:
        timing.set_tracing(False)
        timing.clear()
        graphs.clear()


@pytest.mark.cuda
def test_replays_count_the_eager_work(dev):
    """The ray-query pairs a traced replay adds on the device equal those
    of an eager traced call at the same inputs, and so do the lanes; a
    capture, which runs no kernel, counts neither (the key's eager run and
    its capture step, which replays once, count two calls)."""
    from redner_tpu_torch import timing

    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    scene = _scene(dev, res=(32, 32))
    graphs.clear()
    timing.set_tracing(True)
    try:
        with torch.no_grad():
            ic.reset_work_counts()
            with graphs.disable():
                rtt.render_image(scene, opts, seed=7)
            eager = ic.work_counts()
            ic.reset_work_counts()
            for seed in (7, 7):  # the key's eager run, then the capture
                rtt.render_image(scene, opts, seed=seed)
            setup = ic.work_counts()
            ic.reset_work_counts()
            rtt.render_image(scene, opts, seed=7)  # a replay
            replay = ic.work_counts()
    finally:
        timing.set_tracing(False)
        timing.clear()
        graphs.clear()
    assert eager["closest_hit"][0] > 0 and eager["any_hit"][1] > 0
    assert replay == eager
    assert setup == {k: (2 * p, 2 * n) for k, (p, n) in eager.items()}


@pytest.mark.cuda
def test_untraced_graphs_hold_no_tracing_kernel(dev):
    """A replay of a graph captured with tracing on runs the untraced
    graph's kernels and one counter add per ray query, nothing else (its
    events are not kernels): the untraced graph holds none of them."""
    import collections

    from redner_tpu_torch import timing

    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    scene = _scene(dev, res=(32, 32))

    def replayed():
        with torch.no_grad():
            for _ in range(2):  # the key's eager run, then the capture
                rtt.render_image(scene, opts, seed=3)
            return collections.Counter(_kernels_of(
                lambda: rtt.render_image(scene, opts, seed=3)))

    graphs.clear()
    ic.reset_launch_counts()
    with torch.no_grad(), graphs.disable():
        rtt.render_image(scene, opts, seed=3)
    queries = sum(ic.LAUNCHES.values())
    untraced = replayed()
    timing.set_tracing(True)
    try:
        traced = replayed()
    finally:
        timing.set_tracing(False)
        timing.clear()
        graphs.clear()
    extra = traced - untraced
    assert queries > 0 and not untraced - traced
    assert len(extra) == 1 and sum(extra.values()) == queries


@pytest.mark.cuda
def test_tracing_changes_no_card_result(dev):
    """Graphed gradient steps on the card with tracing on and off: the
    replayed image bit for bit, and each leaf's gradient as close to one of
    three untraced replays as those are to each other (the index
    backward's atomics may sum in any order; where they do not, that is
    bit for bit)."""
    from redner_tpu_torch import timing

    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    scene = _scene(dev, res=(32, 32))
    w = np.random.default_rng(9).uniform(0.5, 1.5, (32, 32, 3)).astype(
        np.float32)
    render = lambda s, sd: rtt.render(s, opts, seed=sd)  # noqa: E731
    graphs.clear()
    runs = {False: [], True: []}
    try:
        for traced, replays in ((False, 3), (True, 1)):
            timing.set_tracing(traced)
            for i in range(2 + replays):  # eager, capture, then replays
                out = _leaf_grads(render, scene, 5, w)
                if i >= 2:
                    runs[traced].append(out)
            timing.set_tracing(False)
    finally:
        timing.set_tracing(False)
        timing.clear()
        graphs.clear()
    (img, grads), = runs[True]
    for ref_img, _ in runs[False]:
        assert torch.equal(ref_img, img)
    for j, g in enumerate(grads):
        us = [u[1][j] for u in runs[False]]
        tol = max(float((a - b).abs().max())
                  for a, b in itertools.combinations(us, 2))
        assert min(float((g - u).abs().max()) for u in us) <= tol


# ------------------------------------------------------------ row gathers

# The gradient cell's tables: the light's intensity, the constant material
# stacks (3 materials), the material flag rows, the face rows.
GATHER_TABLES = ((1, 3), (3, 3), (3, 12), (15752, 34))


@pytest.fixture(scope="module")
def hit_ids(dev):
    """Triangle ids of a 256x256 primary pass over a 15,752-triangle scene
    (the gradient cell's sphere, floor and light), pixel centres, in
    render.swizzle_order: 65,536 lanes as the renderer gathers them."""
    from redner_tpu_torch.camera import sample_primary_rays
    from redner_tpu_torch.render import _swizzle_tensors

    scene = _scene(dev, theta=64, phi=128, res=(256, 256))
    fs = rtt.flatten_scene(scene)
    assert fs.num_triangles == 15752
    order, _ = _swizzle_tensors(256, 256, dev)
    with torch.no_grad():
        ray, _ = sample_primary_rays(
            scene.camera, torch.full((65536, 2), 0.5, device=dev),
            pixel_order=order)
        tri = accel.intersect(fs, ray, presorted=True).tri_id
    assert bool((tri >= 0).any()) and bool((tri < 0).any())
    return tri, fs.face_material_id[tri.clamp(0, 15751)]


def _gather_ids(kind, rows, hit_ids, dev):
    """65,536 ids for a table of `rows` rows: all equal, the hit record's
    (triangle ids for the face table, their material ids for the others;
    misses are -1), or uniform over [-2, rows + 2) (out of range clamps)."""
    if kind == "equal":
        return torch.full((65536,), rows // 2, dtype=torch.int64, device=dev)
    if kind == "hits":
        return hit_ids[0] if rows > 3 else hit_ids[1]
    g = torch.Generator(device=dev).manual_seed(rows)
    return torch.randint(-2, rows + 2, (65536,), generator=g, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["equal", "hits", "random"])
@pytest.mark.parametrize("rows,cols", GATHER_TABLES)
def test_row_gather_kernels_match_plain(dev, hit_ids, rows, cols, kind):
    """At the gradient cell's shapes the gather equals table[clamp(idx)]
    bit for bit, and the scatter equals the float64 plain sum within 1e-5
    of its largest value (float32 sums taken in another order than the
    plain version's: the warps' trees, the blocks' and levels' partials);
    the launch counter shows the variant the table's size picks, and a
    second run gives the same bits."""
    from redner_tpu_torch.ops import gather_cuda as gc

    idx = _gather_ids(kind, rows, hit_ids, dev)
    g = torch.Generator(device=dev).manual_seed(cols)
    table = torch.randn((rows, cols), generator=g, device=dev)
    src = torch.randn((65536, cols), generator=g, device=dev)
    src[::7] = 0.0  # masked lanes send zeros
    gc.reset_launch_counts()
    out = gc.gather_kernel(table, idx)
    assert torch.equal(out, gc.gather_plain(table, idx))
    got = gc.scatter_kernel(src, idx, rows)
    torch.cuda.synchronize()
    want = gc.scatter_plain(src.double(), idx, rows)
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    variant = gc.scatter_variant(rows, cols, 4)
    assert gc.LAUNCHES == {"gather_rows": 1, "scatter_rows.block": 0,
                           "scatter_rows.warp": 0,
                           "scatter_rows." + variant: 1}
    assert torch.equal(gc.scatter_kernel(src, idx, rows), got)


def _warp_updates(n, cols):
    """The warp variant's writes when every id is equal: one row of cols
    values a tile at every level."""
    from redner_tpu_torch.ops import gather_cuda as gc

    total = 0
    while n:
        total += -(-n // 32) * cols
        n = gc.next_level(n)
    return total


@pytest.mark.cuda
def test_row_scatter_counts_its_merges(dev):
    """With tracing on the scatters add their lane-columns and updates on
    the device: every id equal, the warp variant writes one row a tile at
    each level, and the block variant one table a block."""
    from redner_tpu_torch import timing
    from redner_tpu_torch.ops import gather_cuda as gc

    idx = torch.full((65536,), 5, dtype=torch.int64, device=dev)
    src = torch.rand((65536, 34), device=dev) + 0.5
    timing.set_tracing(True)
    try:
        gc.scatter_kernel(src, idx, 15752)  # makes the counters
        gc.reset_work_counts()
        gc.scatter_kernel(src, idx, 15752)
        warp = gc.work_counts()
        gc.reset_work_counts()
        gc.scatter_kernel(src[:, :3], idx, 8)
        block = gc.work_counts()
    finally:
        timing.set_tracing(False)
        gc.reset_work_counts()
    assert warp == (65536 * 34, _warp_updates(65536, 34))
    blocks, _ = gc.block_grid(
        65536, 8 * 3 * 4,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    assert block == (65536 * 3, blocks * 8 * 3)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(1, 3), (15752, 34)])
def test_row_gather_replays_in_a_cuda_graph(dev, hit_ids, rows, cols):
    """A captured gather and its backward (both variants) replay on new
    ids and upstream weights written into the static inputs, bit for bit
    as the eager calls compute them."""
    from redner_tpu_torch.ops import gather_cuda as gc

    table = torch.randn((rows, cols), device=dev, requires_grad=True)
    idx = _gather_ids("hits", rows, hit_ids, dev).clone()
    w = torch.randn((65536, cols), device=dev)

    def body():
        out = gc.gather_rows(table, idx)
        (grad,) = torch.autograd.grad((out * w).sum(), table)
        return out.detach(), grad

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()  # the library's build and load, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = body()
    for seed in (1, 2):
        g = torch.Generator(device=dev).manual_seed(seed)
        idx.copy_(torch.randint(-1, rows + 1, (65536,), generator=g,
                                device=dev))
        w.copy_(torch.randn((65536, cols), generator=g, device=dev))
        graph.replay()
        out, grad = body()
        assert torch.equal(static[0], out)
        assert torch.equal(static[1], grad)


@pytest.mark.cuda
def test_row_gather_second_derivatives_on_the_card(dev):
    """gradcheck and gradgradcheck through the kernels in float64, on both
    variants, ids out of range included."""
    from redner_tpu_torch.ops import gather_cuda as gc

    idx = torch.tensor([[0, 3, 3, -1], [7, 2, 2, 2]], device=dev)
    for rows, cols in ((4, 3), (64, 16)):
        t = torch.randn((rows, cols), dtype=torch.float64, device=dev,
                        requires_grad=True)
        fn = lambda x: gc.gather_rows(x, idx) ** 2  # noqa: E731
        assert torch.autograd.gradcheck(fn, (t,))
        assert torch.autograd.gradgradcheck(fn, (t,))


@pytest.mark.cuda
def test_render_gradient_scatters_through_the_kernels(dev):
    """An eager render gradient on the card launches both scatter variants
    (material and light tables; face rows) and no plain gather."""
    from redner_tpu_torch.ops import gather_cuda as gc

    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    scene = _scene(dev, res=(32, 32))
    gc.reset_launch_counts()
    with graphs.disable():
        _leaf_grads(lambda s, sd: rtt.render(s, opts, seed=sd), scene, 5,
                    np.ones((32, 32, 3), np.float32))
    assert gc.LAUNCHES["gather_rows"] > 0
    assert gc.LAUNCHES["scatter_rows.block"] > 0
    assert gc.LAUNCHES["scatter_rows.warp"] > 0
