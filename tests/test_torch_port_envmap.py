"""The port's environment map against redner_tpu on the CPU.

envmap_eval, envmap_sample and envmap_pdf on numpy-seeded directions and
uniforms (the poles and the seam included), on a 16x32 and a 13x27 map,
match the JAX package at rtol 1e-5; envmap_pdf integrates to one over the sphere (Monte Carlo, the port
alone); the envmap gradient of the image matches finite differences (the
check of tests/test_gradients.py on the port).  The scene test against
JAX, which pays this module's one JAX compile, is in
tests/test_torch_port_envmap_scene.py: a file of its own, so that the
lane's workers take it after the files of many tests."""

import jax
import numpy as np
import pytest
import torch

import redner_tpu as rt
import redner_tpu_torch as rtt
from redner_tpu import envmap as jenv
from redner_tpu.core.types import RayDifferential as JRayDiff
from redner_tpu_torch import envmap as tenv
from redner_tpu_torch.core.types import RayDifferential as TRayDiff
from redner_tpu_torch.scene import flatten_scene
from tests.scene_util import envmap_scene
from tests.torch_port_util import (port_scene,  # noqa: F401
                                   two_torch_threads)

SEED = 3
OPTS = dict(num_samples=4, max_bounces=1)


def _t(x):
    return torch.tensor(np.asarray(x))


def _hdr_envmap(h=16, w=32, seed=0):
    """A sky gradient with one bright sun lobe, turned about the vertical
    axis (which maps the poles exactly, so both packages see them)."""
    rng = np.random.default_rng(seed)
    th = (np.arange(h)[:, None] + 0.5) / h
    ph = (np.arange(w)[None, :] + 0.5) / w
    sky = np.stack([0.3 + 0.5 * th, 0.4 + 0.3 * th, 0.8 - 0.4 * th], -1) \
        * np.ones((h, w, 1))
    sun = 40.0 * np.exp(-((th - 0.3) ** 2 + (ph - 0.6) ** 2) / 0.004)
    values = (sky + sun[..., None] * np.asarray([1.0, 0.9, 0.7])
              + rng.uniform(0, 0.05, (h, w, 3))).astype(np.float32)
    a = np.radians(25.0)
    m = np.asarray([[np.cos(a), 0, np.sin(a), 0], [0, 1, 0, 0],
                    [-np.sin(a), 0, np.cos(a), 0], [0, 0, 0, 1]], np.float32)
    return values, m


def _packed_pair(h=16, w=32):
    values, m = _hdr_envmap(h, w)
    jpe = jenv.pack_envmap(rt.make_environment_map(values, env_to_world=m))
    env = rtt.make_environment_map(values, env_to_world=m, device="cpu")
    # One inverse for both packages, so the comparison sees only the maps.
    env.world_to_env = torch.tensor(np.asarray(jpe.world_to_env))
    return jpe, tenv.pack_envmap(env)


# 16x32: every mip level halves exactly; 13x27: odd sizes, non-divisible
# levels and the remainder wrap.
@pytest.mark.parametrize("size", [(16, 32), (13, 27)], ids=str)
def test_envmap_functions_match_jax(size):
    jpe, tpe = _packed_pair(*size)
    for name in ("sample_cdf_xs", "sample_cdf_ys", "base_luminance"):
        np.testing.assert_allclose(getattr(tpe, name).numpy(),
                                   np.asarray(getattr(jpe, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(tpe.pdf_norm), float(jpe.pdf_norm),
                               rtol=1e-5)
    # The functions on the same tables: the two cumsums round differently
    # in the last bit, which the sample's (s - cdf0) / (cdf1 - cdf0) of a
    # dark row magnifies.
    for name in ("sample_cdf_xs", "sample_cdf_ys"):
        setattr(tpe, name, torch.tensor(np.asarray(getattr(jpe, name))))
    rng = np.random.default_rng(1)
    n = 512
    d = rng.normal(0, 1, (n, 3))
    # The poles, and the seam u = 0 | 1 of the map (local -z, world below).
    a = np.radians(25.0)
    d[:4] = [[0, 1, 0], [0, -1, 0], [np.sin(a), 0, np.cos(a)],
             [-np.sin(a), 0, -np.cos(a)]]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    dd = (rng.normal(0, 1e-2, (4, n, 3))).astype(np.float32)
    dd[:, :8] = 0.0
    u = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u[:4] = [[0.0, 0.0], [0.999999, 0.999999], [0.5, 0.0], [0.0, 0.5]]

    @jax.jit
    def jfns(d, dd, u):
        diff = JRayDiff(org_dx=dd[0], org_dy=dd[1], dir_dx=dd[2],
                        dir_dy=dd[3])
        return (jenv.envmap_eval(jpe, d, diff), jenv.envmap_sample(jpe, u),
                jenv.envmap_pdf(jpe, d))

    ref = jfns(d, dd, u)
    got = (tenv.envmap_eval(tpe, _t(d), TRayDiff(*[_t(x) for x in dd])),
           tenv.envmap_sample(tpe, _t(u)), tenv.envmap_pdf(tpe, _t(d)))
    for name, g, r in zip(("eval", "sample", "pdf"), got, ref):
        r = np.asarray(r)
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-6 * np.abs(r).max(), err_msg=name)


def test_envmap_pdf_integrates_to_one():
    """Over uniform directions, mean(pdf) x 4 pi = 1 (Monte Carlo, 2^18
    directions, on the map with the sun lobe)."""
    _, tpe = _packed_pair()
    g = torch.Generator().manual_seed(0)
    d = torch.randn((1 << 18, 3), generator=g)
    pdf = tenv.envmap_pdf(tpe, d / d.norm(dim=-1, keepdim=True))
    assert float(pdf.min()) >= 0
    est = float(pdf.mean()) * 4.0 * np.pi
    assert abs(est - 1.0) < 0.02, est


def test_world_to_env_is_its_own_leaf():
    m = torch.eye(4, requires_grad=True)
    env = rtt.make_environment_map(np.ones((4, 8, 3), np.float32),
                                   env_to_world=m, device="cpu")
    assert not env.world_to_env.requires_grad
    assert torch.equal(env.world_to_env, torch.eye(4))


def test_envmap_grad_matches_fd():
    """tests/test_gradients.py's envmap check on the port: d/d scale of the
    image sum, against a central difference."""
    ts = port_scene(envmap_scene(res=(8, 8)))
    opts = rtt.RenderOptions(**OPTS)
    tex0 = ts.envmap.values.texels.clone()

    def loss(scale):
        ts.envmap.values.texels = tex0 * scale
        return torch.sum(rtt.render_image(ts, opts, seed=SEED))

    s0 = torch.tensor(1.0, requires_grad=True)
    g = torch.autograd.grad(loss(s0), s0)[0]
    eps = 1e-3
    with torch.no_grad():
        fd = (loss(torch.tensor(1.0 + eps)) - loss(torch.tensor(1.0 - eps))) \
            / (2 * eps)
    ts.envmap.values.texels = tex0
    np.testing.assert_allclose(float(g), float(fd), rtol=2e-2)


def test_envmap_scene_flattens():
    """The envmap is a light: one slot, last in the pmf; with no area
    light it takes all of it."""
    ts = port_scene(envmap_scene(res=(4, 4)))
    fs = flatten_scene(ts)
    assert fs.has_envmap and fs.num_area_lights == 0 and fs.num_lights == 1
    assert ts.num_lights == 1
    assert torch.equal(fs.light_pmf, torch.ones(1))
    assert not fs.envmap.sample_cdf_xs.requires_grad
