"""The tutorials' inverse-rendering loops on the port
(tutorials/torch_port/*.py) on the CPU: each runs two Adam steps at a
small size and its loss falls; tutorials 01 and 02 give the JAX
tutorials' first loss and gradient at a matched seed (rtol 1e-3); 03-05
and the compat 01 give the gradient of a direct rtt.render (or
render_deferred) of the scene their first step renders, which the other
port tests hold against JAX.

The JAX tutorials (imported by path, here only) take ~2 minutes cold for
the two first gradients, so the fast lane holds the port against their
values recorded from that computation (JAX_FIRST), and the `slow` test
recomputes them live and checks the recording."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import redner_tpu_torch as rtt
from tests.torch_port_util import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (8, 8)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port(name):
    return _load(os.path.join(ROOT, "tutorials", "torch_port", name + ".py"),
                 f"port_tutorial_{name[:2]}_{len(name)}")


# The JAX tutorials' first step at RES: (loss, gradient) of 01 and (loss,
# (d position, d look_at)) of 02, computed by _jax_first.
JAX_FIRST = (
    (0.0024663221556693316,
     [[0.001511772396042943, 0.0008351756841875613, 0.0002816893393173814],
      [-0.002884557005017996, 0.0008326191455125809, 0.00021287309937179089],
      [-0.0009150352561846375, 0.0021278480999171734,
       0.00040333092329092324]]),
    (0.10129781812429428,
     ([-0.000431230291724205, -0.040416426956653595, -0.011621888726949692],
      [0.11494292318820953, -0.34195706248283386, -0.03730136901140213])))


def _jax_first():
    """The JAX tutorials 01 and 02 at RES: the loss and gradient of their
    first step (seed 1) against their targets (seed 0)."""
    import jax
    import jax.numpy as jnp

    import redner_tpu as rt

    t1 = _load(os.path.join(ROOT, "tutorials",
                            "01_optimize_single_triangle.py"), "jax_t01")
    t2 = _load(os.path.join(ROOT, "tutorials", "02_pose_estimation.py"),
               "jax_t02")
    p1, p2 = port("01_optimize_single_triangle"), port("02_pose_estimation")

    def at(scene):
        return scene.replace(camera=scene.camera.replace(resolution=RES))

    o1 = rt.RenderOptions(num_samples=16, max_bounces=1)
    o2 = rt.RenderOptions(num_samples=8, max_bounces=1)
    tgt1 = rt.render(at(t1.make_scene(jnp.asarray(p1.TARGET_VERTICES))), o1,
                     seed=0)
    tgt2 = rt.render(at(t2.make_scene(jnp.asarray(p2.TARGET_POSITION),
                                      jnp.asarray(p2.TARGET_LOOK_AT))), o2,
                     seed=0)
    f1 = lambda v: jnp.mean(
        (rt.render(at(t1.make_scene(v)), o1, seed=1) - tgt1) ** 2)
    f2 = lambda p, lk: jnp.mean(
        (rt.render(at(t2.make_scene(p, lk)), o2, seed=1) - tgt2) ** 2)
    out = (jax.value_and_grad(f1)(jnp.asarray(p1.START_VERTICES)),
           jax.value_and_grad(f2, argnums=(0, 1))(
               jnp.asarray(p2.START_POSITION), jnp.asarray(p2.START_LOOK_AT)))
    return jax.tree_util.tree_map(np.asarray, out)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())


def _port_01():
    t = port("01_optimize_single_triangle")
    with torch.no_grad():
        target = rtt.render(t.make_scene(t.TARGET_VERTICES, RES, "cpu"),
                            t.OPTIONS, seed=0)
    v = torch.tensor(t.START_VERTICES, requires_grad=True)
    loss = t.loss_fn(v, target, 1, RES, "cpu")
    loss.backward()
    return loss.item(), v.grad


def _port_02():
    t = port("02_pose_estimation")
    geometry = t.make_geometry("cpu")
    with torch.no_grad():
        target = rtt.render(t.make_scene(geometry, t.TARGET_POSITION,
                                         t.TARGET_LOOK_AT, RES), t.OPTIONS,
                            seed=0)
    params = {"position": torch.tensor(t.START_POSITION, requires_grad=True),
              "look_at": torch.tensor(t.START_LOOK_AT, requires_grad=True)}
    loss = t.loss_fn(geometry, params, target, 1, RES)
    loss.backward()
    return loss.item(), (params["position"].grad, params["look_at"].grad)


def _assert_first_steps(want):
    """The port's first loss and gradient of 01 and 02 against want."""
    (loss1, grad1), (loss2, (pos2, look2)) = want
    got_loss, got_grad = _port_01()
    _close(got_loss, loss1)
    _close(got_grad, np.asarray(grad1))
    got_loss, (got_pos, got_look) = _port_02()
    _close(got_loss, loss2)
    _close(got_pos, np.asarray(pos2))
    _close(got_look, np.asarray(look2))


def test_01_02_first_loss_and_gradient_match_jax():
    """Tutorials 01 and 02's first step on the port against the JAX
    tutorials' recorded values."""
    _assert_first_steps(JAX_FIRST)


@pytest.mark.slow
def test_01_02_first_loss_and_gradient_match_jax_live():
    """The JAX tutorials' first steps computed here equal the recording,
    and the port equals them."""
    live = _jax_first()
    (l1, g1), (l2, (p2, k2)) = live
    (r1, rg1), (r2, (rp2, rk2)) = JAX_FIRST
    for a, b in ((l1, r1), (g1, rg1), (l2, r2), (p2, rp2), (k2, rk2)):
        _close(np.asarray(b), a)
    _assert_first_steps(live)


def _direct_03(t, res):
    """Tutorial 03's first step as one direct render: its loss's gradient
    w.r.t. the texels and the roughness."""
    with torch.no_grad():
        target = rtt.render(t.make_scene(t.target_texture(), t.ROUGH_TARGET,
                                         res, "cpu"), t.OPTIONS, seed=0)
    tex = torch.full((16, 16, 3), 0.5, requires_grad=True)
    rough = torch.tensor([0.4], requires_grad=True)
    img = rtt.render(t.make_scene(tex, rough, res, "cpu"), t.OPTIONS, seed=1)
    torch.mean((img - target) ** 2).backward()
    return [tex.grad, rough.grad]


def _direct_04(t, res):
    setup = t.Setup(res, "cpu")
    with torch.no_grad():
        target = setup.render(torch.tensor(t.TARGET_ANGLES))
    angles = torch.zeros(3, requires_grad=True)
    img = rtt.render_deferred(setup.scene(angles), setup.lights,
                              aa_samples=1, seed=1)
    torch.mean((img - target) ** 2).backward()
    return [angles.grad]


def _direct_05(t, res):
    base = t.make_base("cpu")
    (lres, _, spp), _ = t.levels(None, res)
    options = rtt.RenderOptions(num_samples=spp, max_bounces=2)
    with torch.no_grad():
        target = rtt.render(t.scene_with(base, t.DIFFUSE, torch.zeros(3),
                                         lres), options, seed=0)
    leaves = [torch.full((3,), 0.5, requires_grad=True) for _ in t.DIFFUSE]
    leaves.append(torch.tensor([0.15, -0.1, 0.1], requires_grad=True))
    img = rtt.render(t.scene_with(base, leaves[:-1], leaves[-1], lres),
                     options, seed=1)
    t.pyramid_loss(img, target).backward()
    return [x.grad for x in leaves]


def _direct_01_compat(t, res):
    import redner_tpu_torch.compat as pyredner

    rtt.set_device("cpu")
    try:
        with torch.no_grad():
            target = pyredner.render(t.make_scene(torch.tensor(
                [[-1.7, 1.0, 0.0], [1.0, 1.0, 0.0], [-0.5, -1.0, 0.0]]),
                res), num_samples=16, max_bounces=1, seed=0)
        v = torch.tensor([[-2.0, 1.5, 0.3], [0.9, 1.2, -0.3],
                          [-0.4, -1.4, 0.2]], requires_grad=True)
        scene = t.make_scene(v, res)._build()
        img = rtt.render(scene, rtt.RenderOptions(num_samples=4,
                                                  max_bounces=1), seed=0)
        ((img - target) ** 2).sum().backward()
    finally:
        rtt.set_device(None)
    return [v.grad]


# (file, resolution, steps a level, the direct gradient of its first step
# or None).  04 at 32x32, where two steps of its one-sample antialiasing
# noise show the fall; 05 with 16x16 its finest level (the pyramid's 8x8
# level needs 8x8 pixels) and three steps a level: at 4 spp and 2 bounces,
# its second level's per-step seeds hide two steps' fall (the losses of
# two: 1.04 then 1.37; of three: 1.04, 1.37, 0.59).
CASES = [
    ("01_optimize_single_triangle", RES, 2, None),
    ("02_pose_estimation", RES, 2, None),
    ("03_material_texture", RES, 2, _direct_03),
    ("04_fast_deferred_rendering", (32, 32), 2, _direct_04),
    ("05_coarse_to_fine_estimation", (16, 16), 3, _direct_05),
    ("01_optimize_single_triangle_compat", RES, 2, _direct_01_compat),
]


@pytest.mark.parametrize("name,res,steps,direct", CASES,
                         ids=[c[0][:2] + c[0][-7:] for c in CASES])
def test_tutorial_loop_runs_and_its_loss_falls(name, res, steps, direct):
    """A few Adam steps a level on the CPU: finite losses that fall over
    each level; the first step's gradient is the direct render's (rtol
    1e-5)."""
    t = port(name)
    out = t.main(steps=steps, res=res, device="cpu")
    levels = out["losses"]
    levels = levels if isinstance(levels[0], list) else [levels]
    assert np.isfinite(levels).all()
    assert all(lv[-1] < lv[0] for lv in levels), levels
    if direct is not None:
        wants = direct(t, res)
        assert any(float(w.abs().max()) > 0 for w in wants)
        for got, want in zip(out["first_grad"], wants, strict=True):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
