"""redner_tpu_torch core modules against redner_tpu on the CPU: the sampler
(bit-exact), vector math and transforms, the perspective camera, the
package's import boundary and its device rule.

Inputs are made with numpy from fixed seeds and fed to both packages."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu as rt
from redner_tpu import sampler as jsampler
from redner_tpu.core import transform as jxf
from redner_tpu.core import vecmath as jvm
from redner_tpu_torch import camera as tcam
from redner_tpu_torch import sampler as tsampler
from redner_tpu_torch.core import transform as txf
from redner_tpu_torch.core import vecmath as tvm
from tests.torch_port_util import two_torch_threads  # noqa: F401

CPU = "cpu"


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


# ----------------------------------------------------------------------
# Sampler: bit-exact
# ----------------------------------------------------------------------

_SEEDS = [0, 11, 131071 + 11, 0x7FFFFFFF, 0x80000001, 0xFFFFFFFF]


@pytest.mark.parametrize("seed", _SEEDS)
def test_uniform_bit_exact(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    pixel = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    pixel[:4] = [0, 1, 2**31, 2**32 - 1]
    sample = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    dim = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    ref = np.asarray(jsampler.uniform(
        seed, jnp.asarray(pixel, jnp.uint32), jnp.asarray(sample, jnp.uint32),
        jnp.asarray(dim, jnp.uint32)))
    got = tsampler.uniform(seed, _t(pixel.astype(np.int64)),
                           _t(sample.astype(np.int64)),
                           _t(dim.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("dim_start,n_dims", [(0, 2), (2, 4), (6, 3), (9, 7)])
def test_uniforms_bit_exact(dim_start, n_dims):
    pixel = np.arange(0, 70000, 7, dtype=np.int64)
    sample = (pixel * 2654435761) % (2**32)
    ref = np.asarray(jsampler.uniforms(
        11, jnp.asarray(pixel, jnp.uint32),
        jnp.asarray(sample.astype(np.uint32)), dim_start, n_dims))
    got = tsampler.uniforms(11, _t(pixel), _t(sample), dim_start,
                            n_dims).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    drawn = tsampler.draw(tsampler.SamplerType.independent, 11, _t(pixel),
                          _t(sample), dim_start, n_dims).numpy()
    np.testing.assert_array_equal(drawn, got)


def test_sampler_constants():
    for name in ("CAMERA_DIMS", "LIGHT_DIMS", "BSDF_DIMS", "PRIMARY_EDGE_DIMS",
                 "SECONDARY_EDGE_DIMS", "EDGE_SEED_OFFSET"):
        assert getattr(tsampler, name) == getattr(jsampler, name), name


# ----------------------------------------------------------------------
# Vector math and transforms
# ----------------------------------------------------------------------


def _vecs(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 1, (n, 3)).astype(np.float32)
    v[:3] = 0.0  # guard points: zero vectors
    return v


_UNARY = ["normalize", "length", "length_squared", "luminance", "safe_sqrt",
          "safe_rsqrt", "coordinate_system"]


@pytest.mark.parametrize("name", _UNARY)
def test_vecmath_unary(name):
    v = _vecs(512, 1)
    if name in ("safe_sqrt", "safe_rsqrt"):
        v = v[:, 0]
    if name == "coordinate_system":
        v = np.array(jvm.normalize(jnp.asarray(v)))
        v[5] = [0.0, 0.0, -1.0]  # the degenerate branch
    ref = getattr(jvm, name)(jnp.asarray(v))
    vt = _t(v).requires_grad_(True)
    got = getattr(tvm, name)(vt)
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    for r, g in zip(refs, gots):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-6, atol=1e-7)
    torch.sum(sum(g.sum() for g in gots)).backward()
    if name == "length":  # unguarded, like the reference: sqrt'(0) = inf
        vt.grad[:3] = 0.0
    assert torch.isfinite(vt.grad).all()


@pytest.mark.parametrize("name", ["safe_div", "guarded_div", "safe_pow",
                                  "dot", "cross", "distance"])
def test_vecmath_binary(name):
    rng = np.random.default_rng(2)
    a = rng.normal(0, 1, (256, 3)).astype(np.float32)
    b = rng.normal(0, 1, (256, 3)).astype(np.float32)
    b[:4] = 0.0  # guard points
    if name in ("safe_div", "guarded_div", "safe_pow"):
        a, b = a[:, 0], b[:, 0]
    extra = {"guarded_div": (1e-3,), "safe_pow": ()}.get(name, ())
    if name == "safe_pow":
        args_j = (jnp.asarray(b), 2.5)
        bt = _t(b).requires_grad_(True)
        args_t = (bt, 2.5)
        at = None
    else:
        args_j = (jnp.asarray(a), jnp.asarray(b)) + extra
        at = _t(a).requires_grad_(True)
        bt = _t(b).requires_grad_(True)
        args_t = (at, bt) + extra
    ref = getattr(jvm, name)(*args_j)
    got = getattr(tvm, name)(*args_t)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6, atol=1e-7)
    got.sum().backward()
    for x in (at, bt):
        if x is not None:
            assert torch.isfinite(x.grad).all()


def test_searchsorted_right():
    rng = np.random.default_rng(3)
    cdf = np.sort(rng.uniform(0, 1, (64, 9)).astype(np.float32), axis=1)
    q = rng.uniform(0, 1, 64).astype(np.float32)
    ref = np.asarray(jvm.searchsorted_right(jnp.asarray(cdf), jnp.asarray(q)))
    got = tvm.searchsorted_right(_t(cdf), _t(q)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_transforms():
    rng = np.random.default_rng(4)
    m = rng.normal(0, 1, (4, 4)).astype(np.float32)
    m[3] = [0.1, -0.2, 0.05, 2.0]
    p = rng.normal(0, 1, (300, 3)).astype(np.float32)
    for name in ("xfm_point", "xfm_vector", "mat3_apply"):
        ref = getattr(jxf, name)(jnp.asarray(m), jnp.asarray(p))
        got = getattr(txf, name)(_t(m), _t(p))
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    pos, look, up = (np.asarray(x, np.float32) for x in
                     ([0.3, 2.0, -6.0], [0.1, 0.0, 0.2], [0.0, 1.0, 0.1]))
    ref = jxf.look_at_matrix(jnp.asarray(pos), jnp.asarray(look),
                             jnp.asarray(up))
    post = _t(pos).requires_grad_(True)
    got = txf.look_at_matrix(post, _t(look), _t(up))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6, atol=1e-7)
    got.sum().backward()
    g_ref = jax.grad(lambda q: jnp.sum(jxf.look_at_matrix(
        q, jnp.asarray(look), jnp.asarray(up))))(jnp.asarray(pos))
    np.testing.assert_allclose(post.grad.numpy(), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-6)
    vec = np.asarray([0.3, -0.7, 1.1], np.float32)
    for name in ("gen_rotate_matrix", "gen_translate_matrix",
                 "gen_scale_matrix"):
        np.testing.assert_allclose(
            _np(getattr(txf, name)(_t(vec))),
            np.asarray(getattr(jxf, name)(jnp.asarray(vec))), rtol=1e-6,
            atol=1e-7)
    np.testing.assert_allclose(
        _np(txf.gen_perspective_matrix(45.0, 0.01, 100.0)),
        np.asarray(jxf.gen_perspective_matrix(45.0, 0.01, 100.0)),
        rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------------
# Perspective camera
# ----------------------------------------------------------------------


@pytest.mark.parametrize("res", [(16, 16), (12, 20)])
def test_camera_rays_and_differentials(res):
    pos, look, up, fov = [0.3, 2.0, -6.0], [0.1, 0.0, 0.2], [0.0, 1.0, 0.0], 41.0
    jcam = rt.make_camera(position=pos, look_at=look, up=up, fov=fov,
                          resolution=res)
    tcamera = tcam.make_camera(position=pos, look_at=look, up=up, fov=fov,
                               resolution=res, device=CPU)
    n = res[0] * res[1]
    jitter = np.random.default_rng(5).uniform(0, 1, (n, 2)).astype(np.float32)
    order = np.random.default_rng(6).permutation(n)
    from redner_tpu.camera import sample_primary_rays as jrays

    jr, jd = jrays(jcam, jnp.asarray(jitter), pixel_order=jnp.asarray(order))
    tr, td = tcam.sample_primary_rays(tcamera, _t(jitter), pixel_order=_t(order))
    for a, b in ((tr.org, jr.org), (tr.dir, jr.dir), (tr.tmin, jr.tmin),
                 (tr.tmax, jr.tmax)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    # The differentials are finite differences over 1e-3 of the screen:
    # f32 rounding of the two rays is amplified by 1/1e-3.
    for f in ("org_dx", "org_dy", "dir_dx", "dir_dy"):
        np.testing.assert_allclose(_np(getattr(td, f)),
                                   np.asarray(getattr(jd, f)),
                                   rtol=1e-5, atol=2e-5)


def test_camera_ray_gradients():
    pos = np.asarray([0.3, 2.0, -6.0], np.float32)
    kw = dict(look_at=[0.1, 0.0, 0.2], up=[0.0, 1.0, 0.0], fov=41.0,
              resolution=(8, 8))
    jitter = np.random.default_rng(7).uniform(0, 1, (64, 2)).astype(np.float32)
    w = np.random.default_rng(8).normal(0, 1, (64, 3)).astype(np.float32)
    from redner_tpu.camera import sample_primary_rays as jrays

    def jloss(p):
        cam = rt.make_camera(position=p, **kw)
        r, _ = jrays(cam, jnp.asarray(jitter))
        return jnp.sum(r.dir * jnp.asarray(w))

    g_ref = jax.grad(jloss)(jnp.asarray(pos))
    post = _t(pos).requires_grad_(True)
    cam = tcam.make_camera(position=post, device=CPU, **kw)
    r, _ = tcam.sample_primary_rays(cam, _t(jitter))
    torch.sum(r.dir * _t(w)).backward()
    np.testing.assert_allclose(post.grad.numpy(), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-6)


# ----------------------------------------------------------------------
# Package boundary and device rule
# ----------------------------------------------------------------------


def test_import_leaves_jax_out():
    code = (
        "import sys, redner_tpu_torch, redner_tpu_torch.ops.intersect_cuda\n"
        "import redner_tpu_torch.convert, redner_tpu_torch.accel\n"
        "import redner_tpu_torch.io, redner_tpu_torch.meshops\n"
        "import redner_tpu_torch.serialize, redner_tpu_torch.geometry_images\n"
        "import redner_tpu_torch.torch_bridge\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'redner_tpu', 'redner_torch')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_exact_cumsum_does_not_depend_on_the_order():
    """vecmath.exact_cumsum (the card's scan of sampling tables) adds in
    fixed point: every prefix sum within an ulp of the float64 scan, the
    total the same whichever order the terms come in, zeros and signs
    kept; vecmath.cumsum on the CPU is torch.cumsum itself."""
    from redner_tpu_torch.core import vecmath as vm

    rng = np.random.default_rng(1)
    w = rng.exponential(1.0, 50000) * (rng.uniform(size=50000) > 0.3)
    x = torch.as_tensor(w / w.sum(), dtype=torch.float32)
    got = vm.exact_cumsum(x, dim=0)
    torch.testing.assert_close(got, torch.cumsum(x.double(), 0).float(),
                               rtol=1.2e-7, atol=0)
    perm = torch.as_tensor(rng.permutation(50000))
    assert torch.equal(vm.exact_cumsum(x[perm], dim=0)[-1], got[-1])
    assert torch.equal(vm.exact_cumsum(x.flip(0), dim=0)[-1], got[-1])
    assert torch.equal(vm.exact_cumsum(torch.zeros(4), 0), torch.zeros(4))
    assert torch.equal(vm.exact_cumsum(torch.tensor([[1.0, -2.0, 3.0]]), -1),
                       torch.tensor([[1.0, -1.0, 2.0]]))
    assert torch.equal(vm.cumsum(x, dim=0), torch.cumsum(x, dim=0))


def test_entry_point_without_device_needs_cuda(monkeypatch):
    import redner_tpu_torch as rtt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rtt.make_camera(position=[0, 0, -5], look_at=[0, 0, 0], up=[0, 1, 0],
                        fov=45.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        rtt.generate_sphere(4, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        rtt.scene_from_arrays({"camera": {}}, device=None)
    # Asking for the CPU is always allowed.
    rtt.make_camera(position=[0, 0, -5], look_at=[0, 0, 0], up=[0, 1, 0],
                    fov=45.0, device=CPU)
