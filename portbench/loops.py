"""The general generator of the benchmark's traffic: one closed loop per
traffic kind, driven by the parameters of a traffic file.

  grad   render -> loss -> backward -> Adam update -> loss.item(), against
         a target rendered in set-up; the step's seed is the run seed plus
         the step.
  frame  the camera one step along an orbit, a forward render under
         no_grad, the image copied to the host; the frame's seed is the
         run seed plus the frame.

A loop is built in set-up (`make_grad` / `make_frame`), runs its checked
and warm-up calls there, and is then handed to the window as it stands.
What the check needs from those first calls is kept in `loop.check`.
The port is reached only through its user API (`rtt.render`,
`rtt.render_image` and the scene constructors).  The scene, its leaves
and their start come from the configuration's module (`conf`,
run.load_config).
"""

from __future__ import annotations

import contextlib
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

TARGET_SEED_OFFSET = 1_000_003  # the target's render seed, past the steps'
T0 = time.perf_counter()  # the origin of note(); run.py sets its own


def note(what):
    """A set-up stage's end on standard error, in seconds since T0."""
    print(f"[setup] {what} at {time.perf_counter() - T0:.3f} s",
          file=sys.stderr)


class Spans:
    """Host spans around each call into the port, kept in memory:
    (name, start_s, end_s) on time.perf_counter's clock.  Off: no-ops."""

    def __init__(self, on):
        self.on = on
        self.log = []

    @contextlib.contextmanager
    def __call__(self, name):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.log.append((name, t0, time.perf_counter()))


def apply_start(scene, start, leaves, device):
    """Move the scene's leaves to the start and make them require grad;
    returns [(name, tensor)] in the start's order.  leaves: where each
    leaf lives in the scene (a configuration's LEAVES or
    REFERENCE_LEAVES); a leaf that lives outside it (None) is a new
    tensor set to its start."""
    out = []
    with torch.no_grad():
        for name, (how, value) in start.items():
            value = torch.as_tensor(np.asarray(value, np.float32),
                                    device=device)
            if leaves[name] is None:
                out.append((name, value.clone()))
                continue
            t = leaves[name](scene)
            if how == "shift":
                t.add_(value)
            elif how == "scale":
                t.mul_(value)
            else:
                t.copy_(value.reshape(t.shape))
            out.append((name, t))
    for _, t in out:
        t.requires_grad_(True)
    return out


def render_options(rtt, traffic):
    return rtt.RenderOptions(
        num_samples=traffic["num_samples"],
        max_bounces=traffic["max_bounces"],
        use_primary_edge_sampling=traffic.get("primary_edge", False),
        use_secondary_edge_sampling=traffic.get("secondary_edge", False))


def render_target(rtt, cfg, conf, traffic, seed, device):
    """The target image of a gradient loop: the configuration's scene at
    its own values, rendered without gradient."""
    scene = conf.build_scene(rtt, cfg, traffic["resolution"], device)
    with torch.no_grad():
        return rtt.render_image(scene, render_options(rtt, traffic),
                                seed=seed + TARGET_SEED_OFFSET)


def make_grad(rtt, cfg, conf, traffic, seed, device, spans):
    """The gradient loop of `traffic` on the port, through its checked and
    warm-up steps.  loop.step(k) runs step k and returns its loss."""
    opts = render_options(rtt, traffic)
    target = render_target(rtt, cfg, conf, traffic, seed, device)
    note("target rendered")
    scene = conf.build_scene(rtt, cfg, traffic["resolution"], device)
    leaves = apply_start(scene, conf.perturbed(traffic, seed), conf.LEAVES,
                         device)
    params = [t for _, t in leaves]
    adam = traffic["adam"]
    opt = torch.optim.Adam(params, lr=adam["lr"], betas=tuple(adam["betas"]),
                           eps=adam["eps"])

    images = []  # the checked steps' images, for the check

    def step(k):
        with spans("render"):
            img = rtt.render(conf.posed(scene, leaves), opts, seed=seed + k)
        if k < traffic["checked_steps"]:
            images.append(img.detach().cpu())
        loss = torch.mean((img - target) ** 2)
        with spans("backward"):
            loss.backward()
        with spans("optimizer"):
            opt.step()
            opt.zero_grad()
        with spans("loss_read"):
            return loss.item()

    p0 = [t.detach().clone() for t in params]
    beta1 = adam["betas"][0]
    losses, grad_norms, grad_vectors, states = [], None, None, []
    for k in range(traffic["checked_steps"]):
        losses.append(step(k))
        note(f"checked step {k}")
        if k == 0:  # the first gradient, as Adam's first moment holds it
            first = [opt.state[p]["exp_avg"] / (1 - beta1)
                     if "exp_avg" in opt.state[p] else None for p in params]
            grad_norms = [0.0 if g is None else
                          float(torch.linalg.vector_norm(g)) for g in first]
            grad_vectors = [torch.zeros(p.shape) if g is None else g.cpu()
                            for p, g in zip(params, first)]
            del first
        if k + 1 < traffic["checked_steps"]:  # where the next step renders
            states.append([p.detach().cpu().clone() for p in params])
    change_norms = [float(torch.linalg.vector_norm(p.detach() - q))
                    for p, q in zip(params, p0)]
    del p0
    first = traffic["checked_steps"]
    for k in range(first, first + traffic["warm_steps"]):
        step(k)
    return SimpleNamespace(
        kind="grad", step=step, next_k=first + traffic["warm_steps"],
        names=[n for n, _ in leaves], leaves=leaves, scene=scene, opts=opts,
        target=target, opt=opt, params=params,
        check={"losses": losses, "images": images, "grad_norms": grad_norms,
               "grad_vectors": grad_vectors, "states": states,
               "change_norms": change_norms})


def orbit_positions(cfg, traffic, seed, n):
    """(n, 3) float32 camera positions, one step along the orbit a frame,
    from an angle drawn from `seed`."""
    o = traffic["orbit"]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 11])
    a = rng.uniform(0, 2 * np.pi) + np.radians(o["step_deg"]) * np.arange(n)
    return np.stack([o["radius"] * np.sin(a),
                     np.full(n, o["height"]),
                     -o["radius"] * np.cos(a)], -1).astype(np.float32)


def checked_frames(traffic, seed, first):
    """The frames whose images the check compares, drawn from `seed`."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 13])
    picks = rng.choice(traffic["checked_within"], traffic["checked_frames"],
                       replace=False)
    return sorted(int(first + p) for p in picks)


MAX_FRAMES = 20000


def make_frame(rtt, cfg, conf, traffic, seed, device, spans):
    """The frame loop of `traffic` on the port, through its warm-up
    frames.  loop.step(k) renders frame k and returns its host image."""
    opts = render_options(rtt, traffic)
    scene = conf.build_scene(rtt, cfg, traffic["resolution"], device)
    table = torch.as_tensor(orbit_positions(cfg, traffic, seed, MAX_FRAMES),
                            device=device)
    position = scene.camera.position

    def step(k):
        with spans("render"):
            with torch.no_grad():
                position.copy_(table[k % MAX_FRAMES])
                img = rtt.render_image(scene, opts, seed=seed + k)
        with spans("copy_out"):
            return img.cpu()

    note("scene built")
    for k in range(traffic["warm_frames"]):
        step(k)
        note(f"warm frame {k}")
    first = traffic["warm_frames"]
    return SimpleNamespace(
        kind="frame", step=step, next_k=first, scene=scene, opts=opts,
        keep=set(checked_frames(traffic, seed, first)),
        check={"frames": {}})


MAKERS = {"grad": make_grad, "frame": make_frame}


def run_window(loop, seconds):
    """Steps or frames, back to back, until `seconds` have passed; the
    last one ends the window.  Returns (window_s, count, latencies_s)."""
    lat = []
    k = loop.next_k
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        out = loop.step(k)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if loop.kind == "frame" and k in loop.keep:
            loop.check["frames"][k] = out
        k += 1
        if t1 - t_start >= seconds:
            break
    loop.next_k = k
    return t1 - t_start, len(lat), lat
