"""Tutorial 1 on the PyTorch + CUDA port: optimize the vertices of a single
triangle to match a target render (tutorials/01_optimize_single_triangle.py,
the classic first redner example, on redner_tpu_torch).

The JAX tutorial's jax.jit(jax.value_and_grad(loss)) becomes rtt.render and
loss.backward(); on a card each step after the first replays the render's
cached CUDA graphs (redner_tpu_torch.graphs).

Run:  python tutorials/torch_port/01_optimize_single_triangle.py [--cpu]
Outputs land in results/torch_port/tutorial_01/.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

import redner_tpu_torch as rtt  # noqa: E402

OUT = "results/torch_port/tutorial_01"
STEPS = 80
RES = (64, 64)
OPTIONS = rtt.RenderOptions(num_samples=16, max_bounces=1)
TARGET_VERTICES = [[-1.7, 1.0, 0.0], [1.0, 1.0, 0.0], [-0.5, -1.0, 0.0]]
START_VERTICES = [[-1.2, 1.3, 0.1], [0.5, 0.8, 0.0], [-0.7, -0.6, 0.2]]


def make_scene(vertices, res=RES, device=None):
    cam = rtt.make_camera(
        position=[0.0, 0.0, -5.0], look_at=[0.0, 0.0, 0.0],
        up=[0.0, 1.0, 0.0], fov=45.0, resolution=res, device=device)
    tri = rtt.make_shape(vertices=vertices, indices=[[0, 1, 2]],
                         material_id=0, device=device)
    light = rtt.make_shape(
        vertices=[[-1.0, -1.0, -7.0], [1.0, -1.0, -7.0],
                  [-1.0, 1.0, -7.0], [1.0, 1.0, -7.0]],
        indices=[[0, 1, 2], [1, 3, 2]], material_id=0, light_id=0,
        device=device)
    mat = rtt.make_material(diffuse_reflectance=[0.5, 0.5, 0.5],
                            device=device)
    return rtt.make_scene(
        cam, [tri, light], [mat],
        area_lights=[rtt.make_area_light(1, [20.0, 20.0, 20.0],
                                         device=device)])


def loss_fn(vertices, target, seed, res=RES, device=None):
    img = rtt.render(make_scene(vertices, res, device), OPTIONS, seed=seed)
    return torch.mean((img - target) ** 2)


def main(steps=None, res=None, device=None, out=None):
    """`steps` Adam steps (80) at `res` (64x64) on `device` (the card by
    default); images go to `out` when given.  -> {"losses", "step_ms",
    "vertices", "first_grad"}."""
    steps = STEPS if steps is None else steps
    res = RES if res is None else tuple(res)
    dev = rtt.resolve_device(device)
    with torch.no_grad():
        target = rtt.render(make_scene(TARGET_VERTICES, res, dev), OPTIONS,
                            seed=0)
    if out:
        rtt.imwrite(target, f"{out}/target.png")

    # Start from a perturbed triangle; edge sampling supplies the
    # silhouette gradients that make this converge.
    verts = torch.tensor(START_VERTICES, device=dev, requires_grad=True)
    opt = torch.optim.Adam([verts], lr=5e-2)
    losses, step_ms = [], []
    for it in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = loss_fn(verts, target, it + 1, res, dev)
        loss.backward()
        if it == 0:
            first_grad = [verts.grad.clone()]
        opt.step()
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if it % 10 == 0:
            print(f"iter {it:3d}  loss {losses[-1]:.6f}")
            if out:
                with torch.no_grad():
                    rtt.imwrite(rtt.render(make_scene(verts, res, dev),
                                           OPTIONS, seed=0),
                                f"{out}/iter_{it:03d}.png")
    print("final vertices:\n", verts.detach().cpu().numpy())
    if out:
        with torch.no_grad():
            rtt.imwrite(rtt.render(make_scene(verts, res, dev), OPTIONS,
                                   seed=0), f"{out}/final.png")
    return {"losses": losses, "step_ms": step_ms, "first_grad": first_grad,
            "vertices": verts.detach()}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else None, out=OUT)
