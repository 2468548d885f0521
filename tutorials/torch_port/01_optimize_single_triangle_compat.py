"""Tutorial 1 through the pyredner names of the PyTorch + CUDA port:
optimize the vertices of a single triangle to match a target render
(tutorials/01_optimize_single_triangle_torch.py, with
`import redner_tpu_torch.compat as pyredner` in place of redner_torch).

Run:  python tutorials/torch_port/01_optimize_single_triangle_compat.py
      [--cpu]
Outputs land in results/torch_port/tutorial_01_compat/.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

import redner_tpu_torch.compat as pyredner  # noqa: E402

OUT = "results/torch_port/tutorial_01_compat"
STEPS = 100
RES = (64, 64)


def make_scene(vertices, res=RES):
    cam = pyredner.Camera(
        position=[0.0, 0.0, -5.0], look_at=[0.0, 0.0, 0.0],
        up=[0.0, 1.0, 0.0], fov=[45.0], resolution=res)
    obj = pyredner.Object(
        vertices=vertices, indices=[[0, 1, 2]],
        material=pyredner.Material(diffuse_reflectance=[0.9, 0.4, 0.2]))
    light = pyredner.generate_quad_light(
        position=[0.0, 0.0, -7.0], look_at=[0.0, 0.0, 0.0],
        size=[2.0, 2.0], intensity=[20.0, 20.0, 20.0])
    return pyredner.Scene(camera=cam, objects=[obj, light])


def main(steps=None, res=None, device=None, out=None):
    """`steps` Adam steps (100) at `res` (64x64) on `device` (the card by
    default; another is set with pyredner.set_device and reset after);
    images go to `out` when given.  -> {"losses", "step_ms", "vertices",
    "first_grad"}."""
    steps = STEPS if steps is None else steps
    res = RES if res is None else tuple(res)
    if device is None:
        return _run(steps, res, out)
    pyredner.set_device(device)
    try:
        return _run(steps, res, out)
    finally:
        pyredner.set_device(None)


def _run(steps, res, out):
    dev = pyredner.get_device()
    target_vertices = torch.tensor(
        [[-1.7, 1.0, 0.0], [1.0, 1.0, 0.0], [-0.5, -1.0, 0.0]], device=dev)
    with torch.no_grad():
        target = pyredner.render(make_scene(target_vertices, res),
                                 num_samples=16, max_bounces=1, seed=0)
    if out:
        pyredner.imwrite(target, f"{out}/target.png")

    vertices = torch.tensor(
        [[-2.0, 1.5, 0.3], [0.9, 1.2, -0.3], [-0.4, -1.4, 0.2]],
        device=dev, requires_grad=True)
    optimizer = torch.optim.Adam([vertices], lr=5e-2)
    losses, step_ms = [], []
    for it in range(steps):
        t0 = time.perf_counter()
        optimizer.zero_grad()
        img = pyredner.render(make_scene(vertices, res),
                              num_samples=4, max_bounces=1, seed=it)
        loss = ((img - target) ** 2).sum()
        loss.backward()        # edge-sampled visibility gradients included
        if it == 0:
            first_grad = [vertices.grad.clone()]
        optimizer.step()
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if it % 10 == 0:
            print(f"iter {it:3d}  loss {losses[-1]:.5f}")

    if out:
        with torch.no_grad():
            final = pyredner.render(make_scene(vertices, res),
                                    num_samples=16, max_bounces=1, seed=1000)
        pyredner.imwrite(final, f"{out}/final.png")
    print("final vertices:\n", vertices.detach().cpu().numpy())
    print("target vertices:\n", target_vertices.cpu().numpy())
    return {"losses": losses, "step_ms": step_ms, "first_grad": first_grad,
            "vertices": vertices.detach()}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else None, out=OUT)
