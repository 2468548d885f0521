"""The plain reference agrees with the port at a small size on the CPU:
the same image and the same gradient of every leaf (both edge samplers
off), at one and at two bounces.  The reference itself imports neither
the port nor JAX; this test imports both."""

import json

import pytest
import torch

import redner_tpu_torch as rtt
from portbench import loops
from portbench.reference import plain
from portbench.scenes import (PLAIN_LEAVES, apply_start, build_plain,
                              build_scene, perturbed, posed, posed_plain)
from portbench.tests.tiny import REPO

SEED = 4000000007


def _setup(bounces, steps):
    cfg = json.loads((REPO / "portbench/configs/pose_sphere15k.json")
                     .read_text())
    cfg["sphere"]["theta_steps"], cfg["sphere"]["phi_steps"] = steps
    traffic = json.loads((REPO / "portbench/traffic/grad256_noedge.json")
                         .read_text())
    traffic.update(resolution=[16, 16], num_samples=2, max_bounces=bounces)
    return cfg, traffic


@pytest.mark.parametrize("bounces,steps", [(1, (8, 16)), (2, (12, 24))])
def test_reference_matches_port(bounces, steps):
    torch.set_num_threads(2)
    cfg, traffic = _setup(bounces, steps)
    scene = build_scene(rtt, cfg, traffic["resolution"], "cpu")
    leaves = apply_start(scene, perturbed(traffic, SEED))
    img_p = rtt.render(posed(scene, leaves),
                       loops.render_options(rtt, traffic), seed=SEED)
    g_p = torch.autograd.grad((img_p ** 2).sum(), [t for _, t in leaves])

    ref = build_plain(cfg, traffic["resolution"], "cpu")
    ref_leaves = apply_start(ref, perturbed(traffic, SEED), PLAIN_LEAVES)
    img_r = plain.render(posed_plain(ref, ref_leaves), 2, SEED, bounces)
    g_r = torch.autograd.grad((img_r ** 2).sum(),
                              [t for _, t in ref_leaves])
    assert float(img_r.detach().sum()) > 0
    torch.testing.assert_close(img_p, img_r.detach(), rtol=1e-5, atol=1e-4)
    for (name, _), a, b in zip(leaves, g_p, g_r):
        assert float(b.abs().sum()) > 0, name
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3, msg=name)


def test_bound_culling_changes_no_hit():
    """The ray queries skip the rays that miss a mesh's bounding sphere:
    the same hits as testing every ray against every triangle."""
    cfg, traffic = _setup(1, (12, 24))
    fl = plain.flatten(build_plain(cfg, [8, 8], "cpu"))
    g = torch.Generator().manual_seed(5)
    org = torch.randn((2000, 3), generator=g) * 3
    d = torch.nn.functional.normalize(torch.randn((2000, 3), generator=g)
                                      - 0.3 * org, dim=-1)
    tmin = torch.full((2000,), 1e-3)
    tmax = torch.rand((2000,), generator=g) * 8
    whole = plain.Flat(**{**vars(fl), "parts": [
        (0, fl.v0.shape[0], torch.zeros(3), torch.tensor(1e9))]})
    got = plain.closest_hit(fl, org, d, tmin, torch.full_like(tmax, 1e9))
    assert (got >= 0).sum() > 100
    assert torch.equal(got, plain.closest_hit(
        whole, org, d, tmin, torch.full_like(tmax, 1e9)))
    assert torch.equal(plain.any_hit(fl, org, d, tmin, tmax),
                       plain.any_hit(whole, org, d, tmin, tmax))


def test_the_sampler_hashes_known_values():
    """PCG4D of (1, 2, 3, 4), checked by hand against the published
    constants: the first output's top 24 bits as a float."""
    x = [torch.tensor([v]) for v in (1, 2, 3, 4)]
    M = 0xFFFFFFFF
    v = [(int(t) * 1664525 + 1013904223) & M for t in x]
    for rnd in range(2):
        if rnd:
            v = [a ^ (a >> 16) for a in v]
        a, b, c, d = v
        a = (a + b * d) & M
        b = (b + c * a) & M
        c = (c + a * b) & M
        d = (d + b * c) & M
        v = [a, b, c, d]
    got = plain.pcg4d(x)
    assert [int(t) for t in got] == v
    u = plain.uniforms(1, torch.tensor([2]), torch.tensor([3]), 4, 2)
    assert float(u[0, 0]) == (v[0] >> 8) / 2 ** 24


def test_reference_imports_nothing_of_the_port_or_jax():
    import subprocess
    import sys

    code = ("import sys; import portbench.reference.check, "
            "portbench.reference.plain; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('redner_tpu_torch', 'redner_tpu', 'redner_torch', 'jax', "
            "'jaxlib')]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
