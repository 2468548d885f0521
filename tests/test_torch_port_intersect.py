"""redner_tpu_torch ray queries against redner_tpu on the CPU.

The port's ray queries through the plain versions of the two kernels
(accel.intersect / accel.occluded with engine="plain") must return the
same triangle ids, shape ids and occlusion as the Pallas kernels in
interpret mode and as the XLA matmul sweeps, and t within rtol 1e-6, on
the ray sets of tests/test_accel.py and the edge straddle pairs.  The
sphere has > 8 chunks of 512 triangles, so the Morton ray sort and the
chunk culling both engage.  The CUDA kernels themselves run only on the
card (tests/test_torch_port_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu as rt
from redner_tpu.ops import pallas_intersect as jpi
from redner_tpu.ops.intersect import intersect_mm, occluded_mm
from redner_tpu.scene import flatten_scene as jflatten
from redner_tpu_torch import accel as taccel
from redner_tpu_torch.core.types import Ray as TRay
from redner_tpu_torch.ops import intersect as tplain
from redner_tpu_torch.ops import intersect_cuda as tic
from redner_tpu_torch.scene import flatten_scene as tflatten
from tests.test_accel import _on_geometry_rays, _random_rays, _straddle_pairs
from tests.torch_port_util import port_ray, port_scene


def _sphere_scene():
    """A 4828-triangle sphere over a floor quad under a quad light: 10
    chunks of 512 triangles."""
    v, f, uv, nrm = rt.generate_sphere(36, 72)
    cam = rt.make_camera(position=[0.0, 1.5, -4.0], look_at=[0.0, 0.0, 0.0],
                         up=[0.0, 1.0, 0.0], fov=45.0, resolution=(8, 8))
    sphere = rt.make_shape(vertices=v, indices=f, uvs=uv, normals=nrm)
    floor = rt.make_shape(
        vertices=[[-4.0, -1.0, -4.0], [4.0, -1.0, -4.0], [-4.0, -1.0, 4.0],
                  [4.0, -1.0, 4.0]],
        indices=[[0, 2, 1], [1, 2, 3]])
    light = rt.make_shape(
        vertices=[[-0.5, 3.0, -0.3], [0.5, 3.0, -0.3], [-0.5, 3.0, 0.7],
                  [0.5, 3.0, 0.7]],
        indices=[[0, 1, 2], [1, 3, 2]], light_id=0)
    mat = rt.make_material(diffuse_reflectance=[0.5, 0.5, 0.5])
    return rt.make_scene(cam, [sphere, floor, light], [mat],
                         [rt.make_area_light(2, [30.0, 30.0, 30.0])])


def _quad_scene(scale):
    """The quad of test_accel._straddle_pairs, as a Scene."""
    s = scale
    quad = rt.make_shape(
        vertices=[[-0.6 * s, 1.2 * s, -0.5 * s], [0.6 * s, 1.2 * s, -0.5 * s],
                  [-0.6 * s, 1.2 * s, 0.7 * s], [0.6 * s, 1.2 * s, 0.7 * s]],
        indices=[[0, 2, 1], [1, 2, 3]], material_id=0)
    cam = rt.make_camera(position=[0., 3. * s, -6. * s], look_at=[0., 0., 0.],
                         up=[0., 1., 0.], fov=45.0, resolution=(4, 4))
    return rt.make_scene(cam, [quad],
                         [rt.make_material(diffuse_reflectance=[0.5] * 3)])


@pytest.fixture(scope="module")
def sphere():
    scene = _sphere_scene()
    jfs = jflatten(scene)
    tfs = tflatten(port_scene(scene))
    assert tfs.layout.nchunks > tic.SORT_MIN_CHUNKS
    return jfs, tfs


def _plain_hit(tfs, tray):
    return taccel.intersect(tfs, tray, engine="plain")


def _plain_occ(tfs, tray):
    return taccel.occluded(tfs, tray, engine="plain")


def _ray_set(name, jfs):
    if name == "random":
        return _random_rays(1000, seed=21)
    return _on_geometry_rays(jfs, 1000, seed=22)


def _assert_same_hits(jisect, tisect):
    np.testing.assert_array_equal(tisect.tri_id.numpy(),
                                  np.asarray(jisect.tri_id))
    np.testing.assert_array_equal(tisect.shape_id.numpy(),
                                  np.asarray(jisect.shape_id))
    jt = np.asarray(jisect.t)
    fin = np.isfinite(jt)
    np.testing.assert_array_equal(np.isfinite(tisect.t.numpy()), fin)
    np.testing.assert_allclose(tisect.t.numpy()[fin], jt[fin], rtol=1e-6)


@pytest.mark.parametrize("rays", ["random", "on_geometry"])
def test_plain_matches_pallas_and_mm(sphere, rays):
    jfs, tfs = sphere
    jray = _ray_set(rays, jfs)
    tray = port_ray(jray)
    t_hit = _plain_hit(tfs, tray)
    assert t_hit.valid.sum() > 100
    _assert_same_hits(jpi.intersect_pallas(jfs, jray, interpret=True), t_hit)
    _assert_same_hits(intersect_mm(jfs, jray), t_hit)
    t_occ = _plain_occ(tfs, tray).numpy()
    np.testing.assert_array_equal(
        t_occ, np.asarray(jpi.occluded_pallas(jfs, jray, interpret=True)))
    np.testing.assert_array_equal(t_occ, np.asarray(occluded_mm(jfs, jray)))


@pytest.mark.parametrize("rays", ["random", "on_geometry"])
def test_presorted_and_dispatch_agree(sphere, rays):
    """presorted only skips the Morton ray sort; on CPU tensors the default
    dispatch runs the plain version and launches no kernel."""
    jfs, tfs = sphere
    tray = port_ray(_ray_set(rays, jfs))
    ref = _plain_hit(tfs, tray)
    tic.reset_launch_counts()
    for isect in (taccel.intersect(tfs, tray, presorted=True, engine="plain"),
                  taccel.intersect(tfs, tray)):
        np.testing.assert_array_equal(isect.tri_id.numpy(), ref.tri_id.numpy())
        np.testing.assert_array_equal(isect.t.numpy(), ref.t.numpy())
    occ = _plain_occ(tfs, tray).numpy()
    np.testing.assert_array_equal(
        taccel.occluded(tfs, tray, presorted=True, engine="plain").numpy(),
        occ)
    np.testing.assert_array_equal(taccel.occluded(tfs, tray).numpy(), occ)
    assert tic.LAUNCHES == {"closest_hit": 0, "any_hit": 0}


@pytest.mark.parametrize("scale", [1.0, 1000.0])
def test_straddle_pairs(scale):
    jfsq, jray = _straddle_pairs(scale=scale)
    tfs = tflatten(port_scene(_quad_scene(scale)))
    tray = port_ray(jray)
    t_hit = _plain_hit(tfs, tray)
    _assert_same_hits(jpi.intersect_pallas(jfsq, jray, interpret=True), t_hit)
    _assert_same_hits(intersect_mm(jfsq, jray), t_hit)
    hits = t_hit.valid.numpy()
    n = hits.shape[0] // 2
    assert np.mean(hits[:n] != hits[n:]) > 0.8
    np.testing.assert_array_equal(_plain_occ(tfs, tray).numpy(),
                                  np.asarray(occluded_mm(jfsq, jray)))


def test_layout_matches_pallas(sphere):
    jfs, tfs = sphere
    T, idx, cl_min, cl_max = jpi._coeff_layout_build(jfs)
    lay = tfs.layout
    np.testing.assert_array_equal(lay.idx_map.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(lay.cl_min.numpy(), np.asarray(cl_min))
    np.testing.assert_array_equal(lay.cl_max.numpy(), np.asarray(cl_max))
    np.testing.assert_allclose(lay.Tc.numpy(), np.asarray(T), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("rays", ["random", "on_geometry"])
def test_tile_mask_and_ray_sort_match_pallas(sphere, rays):
    jfs, tfs = sphere
    jray = _ray_set(rays, jfs)
    _, _, cl_min, cl_max = jpi._coeff_layout_build(jfs)
    (_, tmin_p, tmax_p, _, ntile, _, (org_p, d_p, live_p),
     perm) = jpi._prepare_rays(jray, sort_rays=True)
    jmask = np.asarray(jpi._tile_chunk_mask(
        org_p, d_p, tmin_p[:, 0], tmax_p[:, 0], live_p, ntile, cl_min, cl_max))
    t = lambda x: torch.as_tensor(np.array(x))
    tmask = tic._tile_chunk_mask(
        t(org_p), t(d_p), t(tmin_p[:, 0]), t(tmax_p[:, 0]), t(live_p), ntile,
        tfs.layout.cl_min, tfs.layout.cl_max, tile=jpi.TILE_N)
    np.testing.assert_array_equal(tmask.numpy(), jmask.astype(bool))
    tray = port_ray(jray)
    d = tray.dir
    tperm = tic._coherence_order(tray.org, d, torch.sum(d * d, -1) > 0)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))
    # Per-tile CSR lists == the Pallas flat step table's (tile, chunk) order.
    tile_of, chunk_of, _, num_steps, _ = jpi._flat_active_table(jnp.asarray(jmask))
    ptr, chunks = tic._active_lists(tmask)
    k = int(num_steps)
    np.testing.assert_array_equal(chunks.numpy(), np.asarray(chunk_of)[:k])
    rows = np.repeat(np.arange(ntile), np.diff(ptr.numpy()))
    np.testing.assert_array_equal(rows, np.asarray(tile_of)[:k])


def test_inactive_tiles_and_padding(sphere):
    """Rays that cull every chunk come back as misses; padded duplicates of
    the last sorted triangle never win; any-hit tiles stop early."""
    _, tfs = sphere
    n = 300  # not a multiple of the tile
    org = torch.zeros((n, 3)) + torch.tensor([0.0, 0.0, -50.0])
    away = torch.tensor([0.0, 0.0, -1.0]).expand(n, 3)
    tray = TRay(org=org, dir=away, tmin=torch.full((n,), 1e-3),
                      tmax=torch.full((n,), float("inf")))
    rb = tic.prepare_rays(tfs, tray)
    assert not rb.tile_active.any()
    isect = _plain_hit(tfs, tray)
    assert (isect.tri_id == -1).all() and torch.isinf(isect.t).all()
    assert not _plain_occ(tfs, tray).any()
    # Toward the sphere: every lane hits, so the any-hit tiles settle on
    # their first active chunk.
    toward = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
    org = torch.stack([torch.linspace(-0.3, 0.3, n), torch.zeros(n),
                       torch.full((n,), -5.0)], -1)
    tray = TRay(org=org, dir=toward, tmin=torch.full((n,), 1e-3),
                      tmax=torch.full((n,), float("inf")))
    rb = tic.prepare_rays(tfs, tray, presorted=True)
    blocked, steps = tplain.anyhit_plain(tfs.layout.Tc, rb)
    assert blocked[:n].all() and not blocked[n:].any()
    active = (rb.tile_ptr[1:] - rb.tile_ptr[:-1]).to(torch.int64)
    assert (steps <= active).all() and (steps >= 1).all()
    best_t, best_i = tplain.closest_plain(tfs.layout.Tc, rb)
    F = tfs.num_triangles
    assert (tfs.layout.idx_map[best_i[:n]] < F).all()
    assert (best_i[:n] < F).all()  # a padded slot never wins
