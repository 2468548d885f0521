"""The comparison that decides `correct`: the plain reference's readings
of a cell, worked out again from the seed, and the numbers that hold the
port's readings against them.

The scene, its leaves, the render and the edge terms of the reference
are the configuration's (`conf`, run.load_config).  Gradient cells
(traffic kind "grad"): the reference builds the scene, renders the
target and follows the loop's first checked_steps steps with its own
Adam; compared are every step's image, each leaf's first gradient and
each leaf's change after those steps.  Where the traffic turns edge
samplers on, the configuration's edge terms (edges.py's) join each
step's gradient.  Frame cells (kind "frame"): the reference renders the
frames that the check drew from the seed, at the same camera positions
and seeds.

mode "tf32" runs the reference as the control: the operands of its
ray-triangle products rounded to TF32, the step below the float32 with
TF32 off that the configurations state.
"""

from __future__ import annotations

import contextlib
import statistics

import torch

from portbench.loops import TARGET_SEED_OFFSET, apply_start, orbit_positions
from portbench.reference import plain

# A leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: its change is not compared.
STILL_LEAF = 1e-3


@contextlib.contextmanager
def precision(mode):
    saved = plain.PRECISION["mode"]
    plain.PRECISION["mode"] = mode
    try:
        yield
    finally:
        plain.PRECISION["mode"] = saved


def _render(conf, scene, traffic, seed):
    return conf.render_reference(scene, traffic["num_samples"], seed,
                                 traffic["max_bounces"])


def _adam(params, grads, m, v, t, adam):
    """Adam's step t (from 1) on params, in place, moments m and v."""
    b1, b2 = adam["betas"]
    with torch.no_grad():
        for p, g, mi, vi in zip(params, grads, m, v):
            mi.mul_(b1).add_(g, alpha=1 - b1)
            vi.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (vi.sqrt() / (1 - b2 ** t) ** 0.5).add_(adam["eps"])
            p.addcdiv_(mi, denom, value=-adam["lr"] / (1 - b1 ** t))


def edge_samplers(traffic, conf):
    """(primary, secondary): the edge samplers that the traffic turns on.
    Raises where it turns on one whose terms the reference does not
    model, or any where the configuration's reference has no edge terms
    (conf.EDGES None), so that an edge-sampled gradient is never compared
    with an interior one."""
    known = {"primary_edge", "secondary_edge"}
    other = sorted(k for k in traffic if "edge" in k and k not in known)
    if other:
        raise NotImplementedError(f"edge options {other} are not modelled")
    prim = bool(traffic.get("primary_edge", False))
    sec = bool(traffic.get("secondary_edge", False))
    if (prim or sec) and conf.EDGES is None:
        raise NotImplementedError(
            f"the reference of {conf.__name__} has no edge terms (EDGES "
            "is None), and the traffic turns an edge sampler on")
    if sec and traffic["max_bounces"] != 1:
        raise NotImplementedError(
            "secondary edges are modelled for direct lighting only "
            f"(max_bounces 1), not {traffic['max_bounces']}")
    return prim, sec


def grad_readings(cfg, conf, traffic, seed, device, mode="fp32",
                  states=None):
    """The reference's losses and images of the first checked_steps steps,
    each leaf's first gradient (its norm and, where edge terms reach it,
    the vector) and each leaf's change norm after those steps.  The
    configuration's edge terms of the samplers that the traffic turns on
    join each step's interior gradient (none where both are off).

    With an edge sampler on, the edge terms are independent samples of the
    program's, and Adam's first step moves each element by lr times its
    sign, so two runs part after one step wherever an element's sign is in
    the noise: with `states` (the program's leaves after each checked step
    but the last) the steps after the first render at the program's
    leaves, and the reference's own Adam follows its own gradients there
    for the change.  Returned as `states`: the leaves the reference's Adam
    reached."""
    prim, sec = edge_samplers(traffic, conf)
    follow = states is not None and (prim or sec)
    res = traffic["resolution"]
    spp, bounces = traffic["num_samples"], traffic["max_bounces"]
    with precision(mode):
        with torch.no_grad():
            target = _render(conf, conf.build_reference(cfg, res, device),
                             traffic, seed + TARGET_SEED_OFFSET)
        scene = conf.build_reference(cfg, res, device)
        topo = conf.EDGES.topology(scene) if prim or sec else None
        leaves = apply_start(scene, conf.perturbed(traffic, seed),
                             conf.REFERENCE_LEAVES, device)
        params = [t for _, t in leaves]
        p0 = [p.detach().clone() for p in params]
        own = [p.detach().clone() for p in params]
        adam = traffic["adam"]
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        losses, images, kept = [], [], []
        first, reach = None, None
        for k in range(traffic["checked_steps"]):
            with torch.no_grad():
                at = own if not follow or k == 0 else [
                    torch.as_tensor(s, device=device) for s in states[k - 1]]
                for p, a in zip(params, at):
                    p.copy_(a)
            posed = conf.posed_reference(scene, leaves)
            img = _render(conf, posed, traffic, seed + k)
            images.append(img.detach().cpu())
            loss = torch.mean((img - target) ** 2)
            g_edge = [None] * len(params)
            if prim or sec:
                adj = (2.0 / img.numel()) * (img - target).detach()
                surr = conf.EDGES.surrogate(posed, adj, spp, seed + k,
                                            bounces, prim, sec, topo)
                if surr.requires_grad:
                    g_edge = torch.autograd.grad(surr, params,
                                                 allow_unused=True)
            g_int = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [(torch.zeros_like(p) if a is None else a)
                     + (0.0 if b is None else b)
                     for p, a, b in zip(params, g_int, g_edge)]
            losses.append(float(loss.detach()))
            if k == 0:
                first = [g.detach().cpu() for g in grads]
                reach = [g is not None for g in g_edge]
            _adam(own, grads, m, v, k + 1, adam)
            if k + 1 < traffic["checked_steps"]:
                kept.append([p.detach().cpu().clone() for p in own])
        change_norms = [float(torch.linalg.vector_norm(p - q))
                        for p, q in zip(own, p0)]
    return {"losses": losses, "images": images,
            "grad_norms": [float(torch.linalg.vector_norm(g))
                           for g in first],
            "grad_vectors": first, "edge_reach": reach,
            "change_norms": change_norms, "states": kept}


def _leaf_gaps(prog, refv, kept, med=None):
    """Per kept leaf, |prog - ref| / max(ref, median ref) (median over the
    kept leaves, or med)."""
    if med is None:
        med = statistics.median([refv[i] for i in kept])
    return [abs(prog[i] - refv[i]) / max(refv[i], med, 1e-30) for i in kept]


def _l1_gap(p, r):
    return float((p.to(r.dtype) - r).abs().sum() / r.abs().sum())


def compare_grad(prog, refr):
    """The numbers of a gradient cell.  image_l1_gap: the worst checked
    step's relative L1 gap of the rendered image (the first step runs
    eagerly, the second captures the graphs, the third replays them).
    grad_gap: the worst leaf's first-gradient norm gap, of the leaves that
    no edge term reaches; edge_grad_gap, where edge terms reach a leaf:
    the worst such leaf's gap of the first-gradient vector.
    change_median_gap:
    the median leaf's gap of the change after the checked steps; its worst
    leaf (change_gap) and the steps' relative loss gaps (loss_gap) are
    read too.  Leaf gaps are against the reference's norm of that leaf or
    of the median leaf, whichever is larger.

    One sample that takes another hit in the two float32 intersection
    tests moves a small loss by up to 7e-04, and where it flips the sign
    of a near-zero gradient element, Adam's per-element step turns it
    into a move of lr for that leaf (PERF.md): the image and the median
    leaf hold steady from seed to seed."""
    g = refr["grad_norms"]
    every = list(range(len(g)))
    med_g = statistics.median(g)
    moving = [i for i in every if g[i] >= STILL_LEAF * med_g]
    change = _leaf_gaps(prog["change_norms"], refr["change_norms"], moving)
    reach = refr.get("edge_reach") or [False] * len(g)
    out = {
        "image_l1_gap": max(_l1_gap(p, r) for p, r in
                            zip(prog["images"], refr["images"])),
        "grad_gap": max(_leaf_gaps(
            prog["grad_norms"], g, [i for i in every if not reach[i]],
            med_g if any(reach) else None)),
        "change_median_gap": statistics.median(change),
        "change_gap": max(change),
        "loss_gap": max(abs(x - y) / abs(y)
                        for x, y in zip(prog["losses"], refr["losses"])),
    }
    if any(reach):
        # The leaves that edge terms reach: the gap of the first gradient
        # vector, which a norm cannot see where a component flips sign.
        out["edge_grad_gap"] = max(
            float(torch.linalg.vector_norm(
                prog["grad_vectors"][i].reshape(-1).double()
                - refr["grad_vectors"][i].reshape(-1).double()))
            / max(g[i], med_g, 1e-30)
            for i in every if reach[i])
    return out


def frame_reference(cfg, conf, traffic, seed, ks, device, mode="fp32"):
    """The reference's images of frames ks: {k: host image}."""
    with precision(mode), torch.no_grad():
        scene = conf.build_reference(cfg, traffic["resolution"], device)
        table = orbit_positions(cfg, traffic, seed, max(ks) + 1)
        out = {}
        for k in ks:
            conf.move_reference_camera(scene, table[k])
            out[k] = _render(conf, scene, traffic, seed + k).cpu()
    return out


def compare_frames(prog, refr):
    """The numbers of a frame cell, worst over the compared frames: the
    relative L1 gap of the image, and the share of pixels whose value is
    off by more than a hundredth of the image's mean."""
    l1, off = 0.0, 0.0
    for k, r in refr.items():
        l1 = max(l1, _l1_gap(prog[k], r))
        d = (prog[k].to(r.dtype) - r).abs()
        px = d.amax(dim=-1) > 0.01 * float(r.abs().mean())
        off = max(off, float(px.to(torch.float64).mean()))
    return {"frame_l1_gap": l1, "frame_px_off": off}
