"""The comparison that decides `correct`: the plain reference's readings
of a cell, worked out again from the seed, and the numbers that hold the
port's readings against them.

Gradient cells (traffic kind "grad"): the reference builds the scene,
renders the target and follows the loop's first checked_steps steps with
its own Adam; compared are every step's image, each leaf's first
gradient and each leaf's change after those steps.  Frame cells (kind
"frame"): the reference renders the frames that the check drew from the
seed, at the same camera positions and seeds.

mode "tf32" runs the reference as the control: the operands of its
ray-triangle products rounded to TF32, the step below the float32 with
TF32 off that the configurations state.
"""

from __future__ import annotations

import contextlib
import statistics

import torch

from portbench.loops import TARGET_SEED_OFFSET, orbit_positions
from portbench.reference import plain
from portbench.scenes import (PLAIN_LEAVES, apply_start, build_plain,
                              perturbed, posed_plain)

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


def _render(scene, traffic, seed):
    return plain.render(scene, traffic["num_samples"], seed,
                        traffic["max_bounces"])


def grad_readings(cfg, traffic, seed, device, mode="fp32"):
    """The reference's losses and images of the first checked_steps steps,
    each leaf's first gradient norm and each leaf's change norm after
    those steps."""
    res = traffic["resolution"]
    with precision(mode):
        with torch.no_grad():
            target = _render(build_plain(cfg, res, device), traffic,
                             seed + TARGET_SEED_OFFSET)
        scene = build_plain(cfg, res, device)
        leaves = apply_start(scene, perturbed(traffic, seed), PLAIN_LEAVES)
        params = [t for _, t in leaves]
        p0 = [p.detach().clone() for p in params]
        adam = traffic["adam"]
        b1, b2 = adam["betas"]
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        losses, images, grad_norms = [], [], None
        for k in range(traffic["checked_steps"]):
            img = _render(posed_plain(scene, leaves), traffic, seed + k)
            images.append(img.detach().cpu())
            loss = torch.mean((img - target) ** 2)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            losses.append(float(loss.detach()))
            if k == 0:
                grad_norms = [float(torch.linalg.vector_norm(g))
                              for g in grads]
            t = k + 1
            with torch.no_grad():
                for p, g, mi, vi in zip(params, grads, m, v):
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (vi.sqrt() / (1 - b2 ** t) ** 0.5).add_(
                        adam["eps"])
                    p.addcdiv_(mi, denom, value=-adam["lr"] / (1 - b1 ** t))
        change_norms = [float(torch.linalg.vector_norm(p.detach() - q))
                        for p, q in zip(params, p0)]
    return {"losses": losses, "images": images, "grad_norms": grad_norms,
            "change_norms": change_norms}


def _leaf_gaps(prog, refv, kept):
    """Per kept leaf, |prog - ref| / max(ref, median ref)."""
    med = statistics.median([refv[i] for i in kept])
    return [abs(prog[i] - refv[i]) / max(refv[i], med, 1e-30) for i in kept]


def _l1_gap(p, r):
    return float((p.to(r.dtype) - r).abs().sum() / r.abs().sum())


def compare_grad(prog, refr):
    """The numbers of a gradient cell.  image_l1_gap: the worst checked
    step's relative L1 gap of the rendered image (the first step runs
    eagerly, the second captures the graphs, the third replays them).
    grad_gap: the worst leaf's first-gradient norm gap.  change_median_gap:
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
    return {
        "image_l1_gap": max(_l1_gap(p, r) for p, r in
                            zip(prog["images"], refr["images"])),
        "grad_gap": max(_leaf_gaps(prog["grad_norms"], g, every)),
        "change_median_gap": statistics.median(change),
        "change_gap": max(change),
        "loss_gap": max(abs(x - y) / abs(y)
                        for x, y in zip(prog["losses"], refr["losses"])),
    }


def frame_reference(cfg, traffic, seed, ks, device, mode="fp32"):
    """The reference's images of frames ks: {k: host image}."""
    with precision(mode), torch.no_grad():
        scene = build_plain(cfg, traffic["resolution"], device)
        table = orbit_positions(cfg, traffic, seed, max(ks) + 1)
        out = {}
        for k in ks:
            scene.camera.position.copy_(torch.as_tensor(table[k]))
            out[k] = _render(scene, traffic, seed + k).cpu()
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
