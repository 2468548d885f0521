"""pose_sphere15k through its configuration's module (run.load_config)
gives, bit for bit, what scenes.py's functions called directly give, as
the harness called them before the module existed: the port's images of
a gradient loop's checked steps and of a frame loop's frames, and the
reference's gradient readings and frames.  8x8 on the CPU, one torch
thread (with two, the index backward's sums vary by an ulp)."""

import pytest
import torch

import redner_tpu_torch as rtt
from portbench import loops, run, scenes
from portbench.reference import check, plain
from portbench.tests.tiny import REPO

SEED = 2147483659


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _pose(traffic_name, **change):
    cfg, conf = run.load_config(REPO, "pose_sphere15k")
    traffic = run._json(REPO, "traffic", traffic_name)
    traffic.update(resolution=[8, 8], num_samples=2, **change)
    return conf.tiny(cfg), conf, traffic


def _direct_reference(cfg, traffic, seed):
    """check.grad_readings of a traffic without edge samplers as it ran on
    scenes.py's and plain.py's functions: target, the checked steps under
    the reference's own Adam, the first gradient's norms, the changes."""
    res, spp, nb = traffic["resolution"], traffic["num_samples"], \
        traffic["max_bounces"]
    with torch.no_grad():
        target = plain.render(scenes.build_plain(cfg, res, "cpu"), spp,
                              seed + loops.TARGET_SEED_OFFSET, nb)
    scene = scenes.build_plain(cfg, res, "cpu")
    leaves = scenes.apply_start(scene, scenes.perturbed(traffic, seed),
                                scenes.PLAIN_LEAVES)
    params = [t for _, t in leaves]
    p0 = [p.detach().clone() for p in params]
    own = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    images, losses, norms = [], [], None
    for k in range(traffic["checked_steps"]):
        with torch.no_grad():
            for p, a in zip(params, own):
                p.copy_(a)
        img = plain.render(scenes.posed_plain(scene, leaves), spp, seed + k,
                           nb)
        images.append(img.detach())
        loss = torch.mean((img - target) ** 2)
        losses.append(float(loss.detach()))
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            params, torch.autograd.grad(loss, params, allow_unused=True))]
        if k == 0:
            norms = [float(torch.linalg.vector_norm(g)) for g in grads]
        check._adam(own, grads, m, v, k + 1, traffic["adam"])
    return {"images": images, "losses": losses, "grad_norms": norms,
            "change_norms": [float(torch.linalg.vector_norm(p - q))
                             for p, q in zip(own, p0)]}


@pytest.mark.parametrize("bounces", [1, 2])
def test_grad_cell_is_as_direct(bounces):
    cfg, conf, traffic = _pose("grad256_noedge", max_bounces=bounces)
    loop = loops.make_grad(rtt, cfg, conf, traffic, SEED, "cpu",
                           loops.Spans(False))

    opts = loops.render_options(rtt, traffic)
    with torch.no_grad():
        target = rtt.render_image(
            scenes.build_scene(rtt, cfg, traffic["resolution"], "cpu"),
            opts, seed=SEED + loops.TARGET_SEED_OFFSET)
    assert torch.equal(target, loop.target)
    scene = scenes.build_scene(rtt, cfg, traffic["resolution"], "cpu")
    leaves = scenes.apply_start(scene, scenes.perturbed(traffic, SEED))
    adam = traffic["adam"]
    opt = torch.optim.Adam([t for _, t in leaves], lr=adam["lr"],
                           betas=tuple(adam["betas"]), eps=adam["eps"])
    for k in range(traffic["checked_steps"]):
        img = rtt.render(scenes.posed(scene, leaves), opts, seed=SEED + k)
        assert torch.equal(img.detach(), loop.check["images"][k])
        torch.mean((img - target) ** 2).backward()
        opt.step()
        opt.zero_grad()

    got = check.grad_readings(cfg, conf, traffic, SEED, "cpu")
    want = _direct_reference(cfg, traffic, SEED)
    assert all(torch.equal(a, b) for a, b in zip(got["images"],
                                                 want["images"]))
    for key in ("losses", "grad_norms", "change_norms"):
        assert got[key] == want[key], key


def test_frame_cell_is_as_direct():
    cfg, conf, traffic = _pose("fwd512")
    loop = loops.make_frame(rtt, cfg, conf, traffic, SEED, "cpu",
                            loops.Spans(False))
    ks = sorted(loop.keep)
    got = {k: loop.step(k) for k in ks}
    refr = check.frame_reference(cfg, conf, traffic, SEED, ks, "cpu")

    res, opts = traffic["resolution"], loops.render_options(rtt, traffic)
    table = loops.orbit_positions(cfg, traffic, SEED, max(ks) + 1)
    scene = scenes.build_scene(rtt, cfg, res, "cpu")
    ref = scenes.build_plain(cfg, res, "cpu")
    with torch.no_grad():
        for k in ks:
            scene.camera.position.copy_(torch.as_tensor(table[k]))
            assert torch.equal(rtt.render_image(scene, opts, seed=SEED + k),
                               got[k])
            ref.camera.position.copy_(torch.as_tensor(table[k]))
            assert torch.equal(plain.render(ref, traffic["num_samples"],
                                            SEED + k, 1), refr[k])
