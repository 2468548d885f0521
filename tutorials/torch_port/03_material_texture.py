"""Tutorial 3 on the PyTorch + CUDA port: recover a diffuse texture and a
roughness from renders (tutorials/03_material_texture.py, after the
reference's SVBRDF-fitting tutorials, on redner_tpu_torch).

Run:  python tutorials/torch_port/03_material_texture.py [--cpu]
Outputs land in results/torch_port/tutorial_03/.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import redner_tpu_torch as rtt  # noqa: E402

OUT = "results/torch_port/tutorial_03"
STEPS = 100
RES = (64, 64)
OPTIONS = rtt.RenderOptions(num_samples=8, max_bounces=1,
                            use_primary_edge_sampling=False,
                            use_secondary_edge_sampling=False)
ROUGH_TARGET = [0.08]


def target_texture():
    """A 16x16 checkerboard of 0.2 and 0.8."""
    return (0.2 + 0.6 * (np.indices((16, 16)).sum(0) % 2)[..., None]
            .repeat(3, -1)).astype(np.float32)


def make_scene(diffuse_texels, roughness, res=RES, device=None):
    cam = rtt.make_camera(
        position=[0.0, 0.0, -3.0], look_at=[0.0, 0.0, 0.0],
        up=[0.0, 1.0, 0.0], fov=45.0, resolution=res, device=device)
    quad = rtt.make_shape(
        vertices=[[-1., -1., 0.], [1., -1., 0.], [-1., 1., 0.],
                  [1., 1., 0.]],
        indices=[[0, 2, 1], [1, 2, 3]],
        uvs=[[0., 1.], [1., 1.], [0., 0.], [1., 0.]],
        material_id=0, device=device)
    light = rtt.make_shape(
        vertices=[[-1., -1., -5.], [1., -1., -5.], [-1., 1., -5.],
                  [1., 1., -5.]],
        indices=[[0, 1, 2], [1, 3, 2]], material_id=0, light_id=0,
        device=device)
    mat = rtt.make_material(
        diffuse_reflectance=torch.clamp(
            torch.as_tensor(diffuse_texels, device=device), 0.0, 1.0),
        specular_reflectance=[0.3, 0.3, 0.3],
        roughness=torch.clamp(torch.as_tensor(roughness, device=device),
                              1e-3, 1.0),
        device=device)
    return rtt.make_scene(
        cam, [quad, light], [mat],
        area_lights=[rtt.make_area_light(1, [10.0, 10.0, 10.0],
                                         device=device)])


def loss_fn(params, target, seed, res=RES):
    dev = params["tex"].device
    img = rtt.render(make_scene(params["tex"], params["rough"], res, dev),
                     OPTIONS, seed=seed)
    return torch.mean((img - target) ** 2)


def main(steps=None, res=None, device=None, out=None):
    """`steps` Adam steps (100) at `res` (64x64) on `device` (the card by
    default); images go to `out` when given.  -> {"losses", "step_ms",
    "roughness", "first_grad"}."""
    steps = STEPS if steps is None else steps
    res = RES if res is None else tuple(res)
    dev = rtt.resolve_device(device)
    with torch.no_grad():
        target = rtt.render(make_scene(target_texture(), ROUGH_TARGET, res,
                                       dev), OPTIONS, seed=0)
    if out:
        rtt.imwrite(target, f"{out}/target.png")

    params = {
        "tex": torch.full((16, 16, 3), 0.5, device=dev, requires_grad=True),
        "rough": torch.tensor([0.4], device=dev, requires_grad=True),
    }
    opt = torch.optim.Adam(list(params.values()), lr=5e-2)
    losses, step_ms = [], []
    for it in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = loss_fn(params, target, it + 1, res)
        loss.backward()
        if it == 0:
            first_grad = [p.grad.clone() for p in params.values()]
        opt.step()
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if it % 20 == 0:
            print(f"iter {it:3d}  loss {losses[-1]:.6f}  "
                  f"rough {params['rough'].item():.3f}")
    if out:
        with torch.no_grad():
            rtt.imwrite(rtt.render(make_scene(params["tex"], params["rough"],
                                              res, dev), OPTIONS, seed=0),
                        f"{out}/final.png")
    print("recovered roughness:", params["rough"].item(),
          "target:", ROUGH_TARGET[0])
    return {"losses": losses, "step_ms": step_ms, "first_grad": first_grad,
            "roughness": params["rough"].item()}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else None, out=OUT)
