"""redner_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card.  Skipped without CUDA: the kernels have no CPU mode.

This file imports neither JAX nor redner_tpu, so it also runs where JAX is
not installed; there, skip the repository's conftest (which pins JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

import redner_tpu_torch as rtt
from redner_tpu_torch import accel
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


@pytest.mark.cuda
def test_any_hit_settle_points_match_plain(dev):
    fs = rtt.flatten_scene(_scene(dev))
    ray = _rays(dev, 4096, seed=2)
    rb = ic.prepare_rays(fs, ray)
    blocked, steps = ic.any_hit(fs.layout.Tc, rb)
    pb, psteps = plain.anyhit_plain(fs.layout.Tc, rb)
    assert torch.equal(blocked != 0, pb)
    assert torch.equal(steps.to(torch.int64), psteps)
    best_t, best_i = ic.closest_hit(fs.layout.Tc, rb)
    pt, pi = plain.closest_plain(fs.layout.Tc, rb)
    assert torch.equal(best_i.to(torch.int64), pi)


@pytest.mark.cuda
def test_inactive_tiles_miss(dev):
    fs = rtt.flatten_scene(_scene(dev))
    n = 300
    ray = Ray(org=torch.tensor([0.0, 0.0, -50.0], device=dev).expand(n, 3),
              dir=torch.tensor([0.0, 0.0, -1.0], device=dev).expand(n, 3),
              tmin=torch.full((n,), 1e-3, device=dev),
              tmax=torch.full((n,), float("inf"), device=dev))
    rb = ic.prepare_rays(fs, ray)
    assert not rb.tile_active.any()
    best_t, best_i = ic.closest_hit(fs.layout.Tc, rb)
    assert torch.isinf(best_t).all() and (best_i == -1).all()
    blocked, steps = ic.any_hit(fs.layout.Tc, rb)
    assert not blocked.any() and not steps.any()


@pytest.mark.cuda
def test_render_matches_cpu(dev):
    opts = rtt.RenderOptions(num_samples=2, max_bounces=2)
    ic.reset_launch_counts()
    img = rtt.render_image(_scene(dev, res=(16, 16)), opts, seed=5).cpu()
    assert ic.LAUNCHES == {"closest_hit": 3, "any_hit": 2}
    ref = rtt.render_image(_scene("cpu", res=(16, 16)), opts, seed=5)
    close = torch.isclose(img, ref, rtol=1e-4, atol=1e-6 * float(ref.max()))
    assert int((~close.all(-1)).sum()) <= 2
