"""Tutorial 5 on the PyTorch + CUDA port: joint material and camera
estimation with global illumination, coarse to fine
(tutorials/05_coarse_to_fine_estimation.py on redner_tpu_torch).

Demonstrates:
  * global illumination (2 bounces) differentiable rendering;
  * a multi-scale (Gaussian-pyramid-style) loss: coarse levels carry
    gradients when the initial guess is far off, fine levels sharpen;
  * box constraints by projecting the parameters after each Adam step;
  * a coarse-to-fine resolution schedule (32x32, then 64x64), each level
    its own key in the render's graph cache.

The JAX tutorial loads the reference's cbox.xml, which is not in this
repository.  The stand-in is a procedural Cornell box of 36 triangles:
five wall quads (white floor, ceiling and back wall, a red left and a green
right wall), a short and a tall box, and a quad light under the ceiling;
its camera is a cam_to_world sensor, as a Mitsuba file gives one.

Run:  python tutorials/torch_port/05_coarse_to_fine_estimation.py [--cpu]
Outputs land in results/torch_port/tutorial_05/.
"""

import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

import redner_tpu_torch as rtt  # noqa: E402
from redner_tpu_torch.core.transform import look_at_matrix  # noqa: E402

OUT = "results/torch_port/tutorial_05"
STEPS = (80, 40)  # iterations per level
RES = (64, 64)  # the finest level; the schedule halves it once
SPP = (8, 4)
# white, red, green, the boxes, the light's
DIFFUSE = [[0.725, 0.71, 0.68], [0.63, 0.065, 0.05], [0.14, 0.45, 0.091],
           [0.725, 0.71, 0.68], [0.78, 0.78, 0.78]]


def _quad(corners):
    return [list(c) for c in corners], [[0, 1, 2], [1, 3, 2]]


def _box(cx, cz, w, h, angle):
    """An upright box on the floor (y = -1), turned by `angle` about y:
    8 vertices, 12 triangles."""
    c, s = math.cos(angle), math.sin(angle)
    verts = []
    for y in (-1.0, -1.0 + h):
        for dx, dz in ((-w, -w), (w, -w), (-w, w), (w, w)):
            verts.append([cx + c * dx + s * dz, y, cz - s * dx + c * dz])
    faces = [[0, 1, 2], [1, 3, 2], [4, 6, 5], [5, 6, 7], [0, 4, 1],
             [1, 4, 5], [2, 3, 6], [3, 7, 6], [0, 2, 4], [2, 6, 4],
             [1, 5, 3], [3, 5, 7]]
    return verts, faces


def make_base(device=None):
    """(shapes, camera-to-world, light) of the Cornell box stand-in."""
    parts = [
        (_quad([(-1, -1, -1), (1, -1, -1), (-1, -1, 1), (1, -1, 1)]), 0),
        (_quad([(-1, 1, -1), (-1, 1, 1), (1, 1, -1), (1, 1, 1)]), 0),
        (_quad([(-1, -1, -1), (-1, 1, -1), (1, -1, -1), (1, 1, -1)]), 0),
        (_quad([(-1, -1, -1), (-1, -1, 1), (-1, 1, -1), (-1, 1, 1)]), 1),
        (_quad([(1, -1, -1), (1, 1, -1), (1, -1, 1), (1, 1, 1)]), 2),
        (_box(0.35, 0.3, 0.3, 0.6, -0.3), 3),
        (_box(-0.35, -0.3, 0.3, 1.2, 0.3), 3),
        (_quad([(-0.25, 0.99, -0.25), (0.25, 0.99, -0.25),
                (-0.25, 0.99, 0.25), (0.25, 0.99, 0.25)]), 4),
    ]
    shapes = [rtt.make_shape(vertices=v, indices=f, material_id=m,
                             light_id=0 if i == len(parts) - 1 else -1,
                             device=device)
              for i, ((v, f), m) in enumerate(parts)]
    light = rtt.make_area_light(len(parts) - 1, [17.0, 12.0, 4.0],
                                device=device)
    dev = shapes[0].vertices.device
    c2w = look_at_matrix(torch.tensor([0.0, 0.0, 3.9], device=dev),
                         torch.zeros(3, device=dev),
                         torch.tensor([0.0, 1.0, 0.0], device=dev))
    return shapes, c2w, light


def downsample(img, k):
    """k x k box-average pyramid level (differentiable)."""
    h, w, c = img.shape
    return torch.mean(
        img[: h - h % k, : w - w % k].reshape(h // k, k, w // k, k, c),
        dim=(1, 3))


def pyramid_loss(img, target):
    """Multi-scale L2: coarse levels see gradients across large offsets."""
    loss = torch.mean((img - target) ** 2)
    for k in (2, 4, 8):
        loss = loss + torch.mean((downsample(img, k)
                                  - downsample(target, k)) ** 2)
    return loss


def scene_with(base, diffuse_list, cam_offset, res):
    """The box with these diffuse reflectances, clamped to [0, 1], and its
    camera translated by cam_offset (the last column of cam_to_world)."""
    shapes, c2w, light = base
    dev = c2w.device
    mats = [rtt.make_material(
        diffuse_reflectance=torch.clamp(torch.as_tensor(d, device=dev),
                                        0.0, 1.0), two_sided=True,
        device=dev) for d in diffuse_list]
    shift = torch.nn.functional.pad(  # the offset in rows 0-2 of column 3
        torch.as_tensor(cam_offset, device=dev)[:, None], (3, 0, 0, 1))
    cam = rtt.make_camera(cam_to_world=c2w + shift, fov=39.3,
                          resolution=res, device=dev)
    return rtt.make_scene(cam, shapes, mats, area_lights=[light])


def levels(steps=None, res=None):
    """(resolution, iterations, spp) of each level: the coarse level at
    half the finest resolution."""
    res = RES if res is None else tuple(res)
    iters = STEPS if steps is None else (steps, steps)
    return [((res[0] // 2, res[1] // 2), iters[0], SPP[0]),
            (res, iters[1], SPP[1])]


def main(steps=None, res=None, device=None, out=None):
    """The coarse-to-fine schedule: `steps` Adam steps a level (80 and 40)
    with `res` (64x64) the finest resolution, on `device` (the card by
    default); images go to `out` when given.  -> {"losses" (by level),
    "step_ms" (by level), "first_grad", "mse", "cam_offset"}."""
    dev = rtt.resolve_device(device)
    base = make_base(dev)
    params = {
        # gray initial guess for every material (the classic tutorial move)
        "diffuse": [torch.full((3,), 0.5, device=dev, requires_grad=True)
                    for _ in DIFFUSE],
        "cam_offset": torch.tensor([0.15, -0.1, 0.1], device=dev,
                                   requires_grad=True),
    }
    # Separate learning rates: the camera moves the whole image, so it
    # takes smaller, steadier steps than the per-material colors.
    opt = torch.optim.Adam([
        {"params": params["diffuse"], "lr": 2e-2},
        {"params": [params["cam_offset"]], "lr": 5e-3}])
    zero = torch.zeros(3, device=dev)
    losses, step_ms = [], []
    for lres, iters, spp in levels(steps, res):
        options = rtt.RenderOptions(num_samples=spp, max_bounces=2)
        with torch.no_grad():
            target = rtt.render(scene_with(base, DIFFUSE, zero, lres),
                                options, seed=0)
        if out:
            rtt.imwrite(target, f"{out}/target_{lres[0]}.png")
        losses.append([])
        step_ms.append([])
        for it in range(iters):
            t0 = time.perf_counter()
            opt.zero_grad()
            img = rtt.render(scene_with(base, params["diffuse"],
                                        params["cam_offset"], lres),
                             options, seed=it + 1)
            loss = pyramid_loss(img, target)
            loss.backward()
            if not losses[0]:
                first_grad = [p.grad.clone() for p in params["diffuse"]
                              + [params["cam_offset"]]]
            opt.step()
            # Box constraints: reflectances live in [0, 1].
            with torch.no_grad():
                for d in params["diffuse"]:
                    d.clamp_(0.0, 1.0)
            losses[-1].append(loss.item())
            step_ms[-1].append((time.perf_counter() - t0) * 1e3)
            if it % 10 == 0:
                print(f"res {lres}  iter {it:3d}  loss {losses[-1][-1]:.6f}"
                      f"  cam_offset "
                      f"{params['cam_offset'].detach().cpu().numpy()}")

    # Held-out evaluation: fresh seed, full configuration.
    eval_res = levels(steps, res)[-1][0]
    eval_opts = rtt.RenderOptions(num_samples=8, max_bounces=2)
    with torch.no_grad():
        eval_target = rtt.render(scene_with(base, DIFFUSE, zero, eval_res),
                                 eval_opts, seed=999)
        final = rtt.render(scene_with(base, params["diffuse"],
                                      params["cam_offset"], eval_res),
                           eval_opts, seed=999)
        mse = float(torch.mean((final - eval_target) ** 2))
        err = max(float(torch.max(torch.abs(
            d - torch.tensor(t, device=dev))))
            for d, t in zip(params["diffuse"], DIFFUSE))
    print(f"held-out image MSE: {mse:.5f}  max diffuse error: {err:.3f}  "
          f"cam_offset: {params['cam_offset'].detach().cpu().numpy()} "
          f"(target: zeros)")
    if out:
        rtt.imwrite(final, f"{out}/final.png")
    return {"losses": losses, "step_ms": step_ms, "first_grad": first_grad,
            "mse": mse, "cam_offset": params["cam_offset"].detach()}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else None, out=OUT)
