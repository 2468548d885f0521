"""The reference's edge terms (portbench/reference/edges.py) against
closed forms, on the CPU: the primary term of a head-on emitting quad
against black, and the secondary term of a half-plane occluder over a
square light (the clipped-polygon contour formula, differentiated in the
occluder's x and in the camera's x, which moves the shading points).
The check raises for edge options it does not model, and reads the
existing cells' reference as before."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import run
from portbench.reference import check, edges, plain
from portbench.scenes import (PLAIN_LEAVES, apply_start, build_plain,
                              perturbed, posed_plain)
from portbench.tests.tiny import REPO


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _t(x):
    return torch.tensor(x, dtype=torch.float32)


def _quad(x0, x1, y0, y1, z):
    """Two triangles of the rectangle at depth z, facing -z."""
    v = _t([[x0, y0, z], [x1, y0, z], [x0, y1, z], [x1, y1, z]])
    return v, torch.tensor([[0, 2, 1], [1, 2, 3]])


def test_primary_term_matches_closed_form():
    """An emitting quad at depth 2 before a 90-degree pinhole looking
    along +z, 16x16: the image's x runs along world -x, so the quad's
    sides image to columns 12.4 (x = -1.1) and 4.4 (x = 0.9) over rows 4
    to 12, four pixels a unit of x.  With the image weighed by its column
    index, moving the quad by dx loses 4 dx of coverage in column 12 and
    gains it in column 4 on each of 8 rows, in 3 channels of radiance 1:
    -8 x 4 x 3 x (12 - 4) = -768."""
    dx = torch.zeros((), requires_grad=True)
    v, f = _quad(-1.1, 0.9, -1.0, 1.0, 2.0)
    v = v + torch.stack([dx, dx * 0, dx * 0])
    scene = plain.Scene(
        plain.Camera(_t([0.0, 0.0, 0.0]), _t([0.0, 0.0, 1.0]),
                     _t([0.0, 1.0, 0.0]), 90.0, 16, 16),
        [plain.Mesh(v, f, diffuse=_t([0.0, 0.0, 0.0]),
                    emission=_t([1.0, 1.0, 1.0]))])
    ramp = torch.arange(16.0)[None, :, None].expand(16, 16, 3)
    img = plain.render(scene, 4, 7, 1)
    img_d = img.detach()
    assert float(img_d[8, 8, 0]) == 1.0 and float(img_d[0, 0, 0]) == 0.0
    surr = edges.surrogate(scene, ramp, 4, 7, 1, True, False)
    g, = torch.autograd.grad((img * ramp).sum() + surr, [dx])
    assert abs(float(g) + 768.0) < 0.01 * 768.0, float(g)


# The half-plane occluder scene: a floor at y = 0, a 2 x 2 light facing
# down at y = 3, a half-plane occluder at y = 1.5 whose edge runs along z
# at x = -0.2, all diffuse 0.7, seen from above.
LIGHT_Y, HALF, OCC_Y, OCC_X, LE, RES = 3.0, 1.0, 1.5, -0.2, 5.0, 16
CAM = (0.0, 1.0, -6.0)


def _occluder_scene(cam_x, occ_dx):
    occ = _t([[OCC_X, OCC_Y, -6.0], [6.0, OCC_Y, -6.0], [OCC_X, OCC_Y, 6.0],
              [6.0, OCC_Y, 6.0]])
    occ = occ + torch.stack([occ_dx, occ_dx * 0, occ_dx * 0]) * _t(
        [[1.0], [0.0], [1.0], [0.0]])
    pos = torch.stack([cam_x, cam_x * 0 + CAM[1], cam_x * 0 + CAM[2]])
    kd = _t([0.7, 0.7, 0.7])
    return plain.Scene(
        plain.Camera(pos, _t([0.0, 0.0, 0.0]), _t([0.0, 1.0, 0.0]), 18.0,
                     RES, RES),
        [plain.Mesh(_t([[-8.0, 0.0, -8.0], [8.0, 0.0, -8.0],
                        [-8.0, 0.0, 8.0], [8.0, 0.0, 8.0]]),
                    torch.tensor([[0, 2, 1], [1, 2, 3]]), diffuse=kd),
         plain.Mesh(_t([[-HALF, LIGHT_Y, -HALF], [HALF, LIGHT_Y, -HALF],
                        [-HALF, LIGHT_Y, HALF], [HALF, LIGHT_Y, HALF]]),
                    torch.tensor([[0, 1, 2], [1, 3, 2]]), diffuse=kd,
                    emission=_t([LE] * 3)),
         plain.Mesh(occ, torch.tensor([[0, 1, 2], [1, 3, 2]]), diffuse=kd)])


def _polygon_irradiance(p, n, verts):
    """The contour formula: E = Le/2 sum_i theta_i (gamma_i . n) over the
    edges of a convex polygon seen from p."""
    v = verts - p[None, :]
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    b = torch.roll(v, -1, dims=0)
    cr = torch.linalg.cross(v, b, dim=-1)
    s = torch.clamp_min(torch.linalg.norm(cr, dim=-1), 1e-30)
    theta = torch.atan2(s, torch.sum(v * b, dim=-1))
    return LE / 2.0 * torch.sum(theta * ((cr / s[:, None]) @ n))


def _clipped(loop, c, d):
    """The light's loop clipped to {x : (x - c) . d >= 0}, its topology
    decided at the values and rebuilt differentiably."""
    s = [float(torch.dot(x - c, d)) for x in loop]
    pts = []
    for i in range(len(loop)):
        j = (i + 1) % len(loop)
        if s[i] >= 0:
            pts.append(loop[i])
        if (s[i] >= 0) != (s[j] >= 0):
            sa, sb = torch.dot(loop[i] - c, d), torch.dot(loop[j] - c, d)
            pts.append(loop[i] + sa / (sa - sb) * (loop[j] - loop[i]))
    return torch.stack(pts) if len(pts) >= 3 else None


def _exact(cam_x, occ_dx, sub=4):
    """Float64 image sum of the occluder scene from the contour formula at
    sub x sub points a pixel, differentiable in both offsets."""
    f64 = dict(dtype=torch.float64)
    pos = torch.stack([cam_x, cam_x * 0 + CAM[1], cam_x * 0 + CAM[2]])
    fwd = -pos / torch.linalg.norm(pos)
    right = torch.linalg.cross(fwd, torch.tensor([0.0, 1.0, 0.0], **f64))
    right = right / torch.linalg.norm(right)
    up = torch.linalg.cross(right, fwd)
    t = math.tan(math.radians(9.0))
    g = (torch.arange(RES * sub, **f64) + 0.5) / (RES * sub)
    sx = (2.0 * g[None, :] - 1.0) * t
    sy = (1.0 - 2.0 * g[:, None]) * t
    d = fwd + sx[..., None] * right + sy[..., None] * up
    hits = pos - (pos[1] / d[..., 1])[..., None] * d  # on y = 0
    loop = torch.tensor([[-HALF, LIGHT_Y, -HALF], [HALF, LIGHT_Y, -HALF],
                         [HALF, LIGHT_Y, HALF], [-HALF, LIGHT_Y, HALF]],
                        **f64)
    e0 = torch.stack([OCC_X + occ_dx, occ_dx * 0 + OCC_Y, occ_dx * 0])
    e1 = e0 + torch.tensor([0.0, 0.0, 1.0], **f64)
    up_n = torch.tensor([0.0, 1.0, 0.0], **f64)
    tot = torch.zeros((), **f64)
    for p in hits.reshape(-1, 3):
        nrm = torch.linalg.cross(e1 - e0, e0 - p)
        # The side of the occluder's plane through p that the open part
        # of the light lies on: where the line to the light's corner meets
        # y = OCC_Y left of the edge.
        q0 = loop[0]
        xc = p[0] + (OCC_Y - p[1]) / (q0[1] - p[1]) * (q0[0] - p[0])
        open_side = (float(torch.dot(q0 - e0, nrm)) > 0) == \
            (float(xc) < float(e0[0]))
        poly = _clipped(loop, e0, nrm if open_side else -nrm)
        if poly is not None:
            tot = tot + 0.7 / math.pi * torch.abs(
                _polygon_irradiance(p, up_n, poly))
    return 3.0 * tot / sub ** 2


@pytest.mark.parametrize("moved", ["occluder", "camera"])
def test_secondary_term_matches_contour_formula(moved):
    """The reference's gradient of the image sum, interior and secondary
    edges, over 8 seeds, against the exact one: moving the occluder (the
    edge's own branch) and moving the camera (the shading points: the
    edge moves against the light point behind it)."""
    z = torch.zeros((), dtype=torch.float64, requires_grad=True)
    exact = _exact(z if moved == "camera" else z.detach(),
                   z if moved == "occluder" else z.detach())
    g_exact = float(torch.autograd.grad(exact, [z])[0])
    gs = []
    for seed in range(8):
        x = torch.zeros((), requires_grad=True)
        zero = torch.zeros(())
        scene = _occluder_scene(x if moved == "camera" else zero,
                                x if moved == "occluder" else zero)
        img = plain.render(scene, 8, seed, 1)
        surr = edges.surrogate(scene, torch.ones_like(img), 8, seed, 1,
                               False, True)
        gs.append(float(torch.autograd.grad(img.sum() + surr, [x])[0]))
    se = np.std(gs, ddof=1) / math.sqrt(len(gs))
    assert abs(np.mean(gs) - g_exact) < max(4.0 * se, 0.02 * abs(g_exact)), \
        (np.mean(gs), se, g_exact)


def test_smith_g1_falls_to_zero_at_grazing():
    """The reference's G1 is Walter et al.'s rational formula down to
    |cos| = 0: continuous across |cos| = 1e-6, where 1/cos^2 - 1 loses its
    1 in float32, and 0 at cos = 0.  A G1 of 1 there makes the glossy
    term grow as 1/|cos| at a silhouette, where the primary edge samples
    hit at grazing."""
    c = _t([0.0, 1e-7, 5e-7, 0.99e-6, 1.0e-6, 1.01e-6, 2e-6, 1e-5])
    w = torch.stack([torch.sqrt(1 - c * c), torch.zeros_like(c), c], -1)
    n = _t([[0.0, 0.0, 1.0]]).expand(c.shape[0], 3)
    r = torch.full(c.shape, 0.05)
    g = plain._smith_g1(w, n, r)
    assert float(g[0]) == 0.0
    assert bool((g[1:] > 0).all()) and bool((g[1:] < 1e-3).all())
    assert bool((torch.diff(g) > 0).all())
    # about 3.535 |cos| / sqrt(r) where a = |cos| / (sqrt(r) sin) is small
    assert torch.allclose(g[1:], 3.535 * c[1:] / math.sqrt(0.05),
                          rtol=1e-3)


def test_edges_import_nothing_of_the_port_or_jax():
    code = ("import sys; import portbench.reference.edges; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('redner_tpu_torch', 'redner_tpu', 'redner_torch', 'jax', "
            "'jaxlib', 'flax')]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _traffic(name):
    return json.loads((REPO / f"portbench/traffic/{name}.json").read_text())


@pytest.mark.parametrize("change", [
    {"secondary_edge": True, "max_bounces": 2},
    {"primary_edge": True, "num_edge_samples": 1024},
])
def test_unmodelled_edge_traffic_raises(change):
    traffic = dict(_traffic("grad256_noedge"), **change)
    _, conf = run.load_config(REPO, "pose_sphere15k")
    with pytest.raises(NotImplementedError):
        check.grad_readings({}, conf, traffic, 1, "cpu")


def test_noedge_reference_is_as_before():
    """check.grad_readings of the grad256_noedge traffic gives, bit for
    bit, what plain.render gives when called as the check has called it
    since the benchmark began: target, three steps of the reference's own
    Adam, the first gradient's norms and the changes."""
    cfg, conf = run.load_config(REPO, "pose_sphere15k")
    cfg["sphere"]["theta_steps"], cfg["sphere"]["phi_steps"] = 6, 12
    traffic = dict(_traffic("grad256_noedge"), resolution=[12, 12],
                   num_samples=2)
    seed = 2147483659
    got = check.grad_readings(cfg, conf, traffic, seed, "cpu")

    res, spp, nb = traffic["resolution"], 2, traffic["max_bounces"]
    with torch.no_grad():
        target = plain.render(build_plain(cfg, res, "cpu"), spp,
                              seed + check.TARGET_SEED_OFFSET, nb)
    scene = build_plain(cfg, res, "cpu")
    leaves = apply_start(scene, perturbed(traffic, seed), PLAIN_LEAVES)
    params = [t for _, t in leaves]
    p0 = [p.detach().clone() for p in params]
    adam = traffic["adam"]
    b1, b2 = adam["betas"]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    for k in range(traffic["checked_steps"]):
        img = plain.render(posed_plain(scene, leaves), spp, seed + k, nb)
        assert torch.equal(img.detach(), got["images"][k])
        loss = torch.mean((img - target) ** 2)
        assert float(loss.detach()) == got["losses"][k]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if k == 0:
            assert [float(torch.linalg.vector_norm(g)) for g in grads] == \
                got["grad_norms"]
        with torch.no_grad():
            for p, g, mi, vi in zip(params, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (vi.sqrt() / (1 - b2 ** (k + 1)) ** 0.5).add_(
                    adam["eps"])
                p.addcdiv_(mi, denom, value=-adam["lr"] / (1 - b1 ** (k + 1)))
    assert [float(torch.linalg.vector_norm(p.detach() - q))
            for p, q in zip(params, p0)] == got["change_norms"]


def _pose(steps=(8, 16), res=16, spp=4):
    cfg = json.loads((REPO / "portbench/configs/pose_sphere15k.json")
                     .read_text())
    cfg["sphere"]["theta_steps"], cfg["sphere"]["phi_steps"] = steps
    traffic = dict(_traffic("grad256_noedge"), resolution=[res, res],
                   num_samples=spp, primary_edge=True, secondary_edge=True)
    return cfg, traffic


def _port_grads(cfg, traffic, seed, adj):
    import redner_tpu_torch as rtt
    from portbench import loops
    from portbench.scenes import build_scene, posed

    scene = build_scene(rtt, cfg, traffic["resolution"], "cpu")
    leaves = apply_start(scene, perturbed(traffic, 4000000007))
    img = rtt.render(posed(scene, leaves), loops.render_options(rtt, traffic),
                     seed=seed)
    return [g.reshape(-1) for g in torch.autograd.grad(
        img, [t for _, t in leaves], grad_outputs=adj)]


def _ref_grads(cfg, traffic, seed, adj):
    scene = build_plain(cfg, traffic["resolution"], "cpu")
    leaves = apply_start(scene, perturbed(traffic, 4000000007), PLAIN_LEAVES)
    posed = posed_plain(scene, leaves)
    img = plain.render(posed, traffic["num_samples"], seed, 1)
    surr = edges.surrogate(posed, adj, traffic["num_samples"], seed, 1,
                           traffic["primary_edge"], traffic["secondary_edge"])
    return [torch.zeros(t.numel()) if g is None else g.reshape(-1)
            for (_, t), g in zip(leaves, torch.autograd.grad(
                (img * adj).sum() + surr, [t for _, t in leaves],
                allow_unused=True))]


def test_port_matches_reference_with_edges():
    """pose_sphere15k at 16x16 with the edge samplers on, a fixed image
    adjoint.  The leaves that no edge term reaches (light, materials)
    match seed by seed, both samplers on.  The geometry leaves with the
    primary sampler alone: the mean over 4 seeds of each side within four
    standard errors of their difference.  (The port's secondary term
    misses the motion of what each sampling strategy holds fixed, so
    with both on the geometry leaves part; PERF.md, section 7.)"""
    cfg, traffic = _pose()
    adj = torch.rand((16, 16, 3), generator=torch.Generator().manual_seed(3))
    for seed in (11, 12):
        p, r = _port_grads(cfg, traffic, seed, adj), \
            _ref_grads(cfg, traffic, seed, adj)
        for name, a, b in list(zip(traffic["leaves"], p, r))[3:]:
            assert float(b.abs().sum()) > 0, name
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3, msg=name)
    traffic["secondary_edge"] = False
    P = [torch.cat(_port_grads(cfg, traffic, s, adj)[:3]) for s in range(4)]
    R = [torch.cat(_ref_grads(cfg, traffic, s, adj)[:3]) for s in range(4)]
    P, R = torch.stack(P).double(), torch.stack(R).double()
    se = torch.sqrt(P.var(0) / 4 + R.var(0) / 4)
    gap = (P.mean(0) - R.mean(0)).abs()
    assert bool((gap <= 4 * se + 1e-3 * R.mean(0).abs().max()).all()), \
        (P.mean(0), R.mean(0), se)
