"""Tutorial 2 on the PyTorch + CUDA port: camera pose estimation, recovering
the camera's position and look-at point from a target image
(tutorials/02_pose_estimation.py on redner_tpu_torch).

Run:  python tutorials/torch_port/02_pose_estimation.py [--cpu]
Outputs land in results/torch_port/tutorial_02/.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

import redner_tpu_torch as rtt  # noqa: E402

OUT = "results/torch_port/tutorial_02"
STEPS = 60
RES = (64, 64)
OPTIONS = rtt.RenderOptions(num_samples=8, max_bounces=1)
TARGET_POSITION = [0.6, 0.8, -4.5]
TARGET_LOOK_AT = [0.0, 0.0, 0.0]
START_POSITION = [0.0, 0.3, -5.2]
START_LOOK_AT = [0.2, -0.2, 0.0]


def make_geometry(device=None):
    """The sphere, floor and light shapes and their materials (built once;
    the JAX tutorial builds them inside its jitted loss)."""
    v, f, uvs, normals = rtt.generate_sphere(16, 32, device=device)
    sphere = rtt.make_shape(vertices=v, indices=f, uvs=uvs, normals=normals,
                            material_id=0, device=device)
    floor = rtt.make_shape(
        vertices=[[-4., -1., -4.], [4., -1., -4.], [-4., -1., 4.],
                  [4., -1., 4.]],
        indices=[[0, 2, 1], [1, 2, 3]], material_id=1, device=device)
    light = rtt.make_shape(
        vertices=[[-1., 4., -1.], [1., 4., -1.], [-1., 4., 1.],
                  [1., 4., 1.]],
        indices=[[0, 1, 2], [1, 3, 2]], material_id=0, light_id=0,
        device=device)
    mats = [
        rtt.make_material(diffuse_reflectance=[0.3, 0.5, 0.8],
                          device=device),
        rtt.make_material(diffuse_reflectance=[0.6, 0.6, 0.6],
                          device=device),
    ]
    lights = [rtt.make_area_light(2, [40.0, 40.0, 40.0], device=device)]
    return [sphere, floor, light], mats, lights


def make_scene(geometry, cam_position, cam_look_at, res=RES):
    shapes, mats, lights = geometry
    cam = rtt.make_camera(
        position=cam_position, look_at=cam_look_at, up=[0.0, 1.0, 0.0],
        fov=45.0, resolution=res, device=shapes[0].vertices.device)
    return rtt.make_scene(cam, shapes, mats, area_lights=lights)


def loss_fn(geometry, params, target, seed, res=RES):
    img = rtt.render(make_scene(geometry, params["position"],
                                params["look_at"], res), OPTIONS, seed=seed)
    return torch.mean((img - target) ** 2)


def main(steps=None, res=None, device=None, out=None):
    """`steps` Adam steps (60) at `res` (64x64) on `device` (the card by
    default); images go to `out` when given.  -> {"losses", "step_ms",
    "position", "first_grad"}."""
    steps = STEPS if steps is None else steps
    res = RES if res is None else tuple(res)
    dev = rtt.resolve_device(device)
    geometry = make_geometry(dev)
    with torch.no_grad():
        target = rtt.render(make_scene(geometry, TARGET_POSITION,
                                       TARGET_LOOK_AT, res), OPTIONS, seed=0)
    if out:
        rtt.imwrite(target, f"{out}/target.png")

    params = {
        "position": torch.tensor(START_POSITION, device=dev,
                                 requires_grad=True),
        "look_at": torch.tensor(START_LOOK_AT, device=dev,
                                requires_grad=True),
    }
    opt = torch.optim.Adam(list(params.values()), lr=2e-2)
    losses, step_ms = [], []
    for it in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = loss_fn(geometry, params, target, it + 1, res)
        loss.backward()
        if it == 0:
            first_grad = [p.grad.clone() for p in params.values()]
        opt.step()
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if it % 10 == 0:
            print(f"iter {it:3d}  loss {losses[-1]:.6f}  "
                  f"pos {params['position'].detach().cpu().numpy()}")
    print("recovered position:", params["position"].detach().cpu().numpy(),
          "target:", TARGET_POSITION)
    return {"losses": losses, "step_ms": step_ms, "first_grad": first_grad,
            "position": params["position"].detach()}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else None, out=OUT)
