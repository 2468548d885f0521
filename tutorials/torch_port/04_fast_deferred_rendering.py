"""Tutorial 4 on the PyTorch + CUDA port: pose estimation through fast
deferred rendering (tutorials/04_fast_deferred_rendering.py on
redner_tpu_torch).

Deferred rendering renders a G-buffer (position / normal / albedo) with the
path tracer at 0 bounces, then shades it in plain torch: a fast approximate
image that is still differentiable end to end (its backward samples the
primary edges).  We recover an object's rotation from a target image.

The JAX tutorial loads the reference's teapot, which is not in this
repository.  The stand-in is generate_sphere(64, 128) (15,748 triangles,
the teapot's count) stretched to an ellipsoid with radii 30, 18 and 24 (the
teapot's extent, which the tutorial's point light is set for), so that its
rotation shows in the image.

Run:  python tutorials/torch_port/04_fast_deferred_rendering.py [--cpu]
Outputs land in results/torch_port/tutorial_04/.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

import redner_tpu_torch as rtt  # noqa: E402

OUT = "results/torch_port/tutorial_04"
STEPS = 60
RES = (64, 64)
RADII = [30.0, 18.0, 24.0]
TARGET_ANGLES = [0.15, -0.3, 0.1]


def euler_to_matrix(angles):
    cx, cy, cz = torch.cos(angles)
    sx, sy, sz = torch.sin(angles)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)
    rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, cx, -sx]),
                      torch.stack([zero, sx, cx])])
    ry = torch.stack([torch.stack([cy, zero, sy]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-sy, zero, cy])])
    rz = torch.stack([torch.stack([cz, -sz, zero]),
                      torch.stack([sz, cz, zero]),
                      torch.stack([zero, zero, one])])
    return rz @ ry @ rx


def make_object(device=None):
    """The stand-in object: the slice's sphere as an ellipsoid."""
    v, f, uvs, normals = rtt.generate_sphere(64, 128, device=device)
    radii = torch.tensor(RADII, device=v.device)
    return rtt.Object(
        vertices=v * radii, indices=f, uvs=uvs,
        normals=torch.nn.functional.normalize(normals / radii, dim=-1),
        material=rtt.make_material(diffuse_reflectance=[0.7, 0.7, 0.7],
                                   device=device))


class Setup:
    """The object, its camera and the deferred lights at one resolution."""

    def __init__(self, res=RES, device=None):
        self.obj = make_object(device)
        self.cam = rtt.automatic_camera_placement([self.obj], resolution=res)
        dev = self.obj.vertices.device
        self.center = torch.mean(self.obj.vertices, dim=0)
        self.lights = [
            rtt.AmbientLight(intensity=torch.tensor([0.15, 0.15, 0.15],
                                                    device=dev)),
            rtt.PointLight(position=self.cam.position * 1.2,
                           intensity=torch.tensor([3e4, 3e4, 3e4],
                                                  device=dev)),
        ]

    def scene(self, angles):
        o = self.obj
        R = euler_to_matrix(angles)
        shape = rtt.make_shape(
            vertices=(o.vertices - self.center) @ R.T + self.center,
            indices=o.indices, uvs=o.uvs, normals=o.normals,
            uv_indices=o.uv_indices, normal_indices=o.normal_indices,
            material_id=0, device=o.vertices.device)
        return rtt.make_scene(self.cam, [shape], [o.material])

    def render(self, angles, seed=0):
        return rtt.render_deferred(self.scene(angles), self.lights,
                                   aa_samples=1, seed=seed)


def loss_fn(setup, angles, target, seed):
    return torch.mean((setup.render(angles, seed) - target) ** 2)


def main(steps=None, res=None, device=None, out=None):
    """`steps` Adam steps (60) at `res` (64x64) on `device` (the card by
    default); images go to `out` when given.  -> {"losses", "step_ms",
    "angles", "first_grad"}."""
    steps = STEPS if steps is None else steps
    res = RES if res is None else tuple(res)
    setup = Setup(res, rtt.resolve_device(device))
    dev = setup.obj.vertices.device
    target_angles = torch.tensor(TARGET_ANGLES, device=dev)
    with torch.no_grad():
        target = setup.render(target_angles)
    if out:
        rtt.imwrite(target, f"{out}/target.png")

    angles = torch.zeros(3, device=dev, requires_grad=True)
    opt = torch.optim.Adam([angles], lr=2e-2)
    losses, step_ms = [], []
    for it in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = loss_fn(setup, angles, target, it + 1)
        loss.backward()
        if it == 0:
            first_grad = [angles.grad.clone()]
        opt.step()
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if it % 10 == 0:
            print(f"iter {it:3d}  loss {losses[-1]:.6f}  "
                  f"angles {angles.detach().cpu().numpy()}")
    err = float(torch.max(torch.abs(angles.detach() - target_angles)))
    print("recovered angles:", angles.detach().cpu().numpy(), " target:",
          TARGET_ANGLES, f" max err {err:.4f}")
    if out:
        with torch.no_grad():
            rtt.imwrite(setup.render(angles), f"{out}/final.png")
    return {"losses": losses, "step_ms": step_ms, "first_grad": first_grad,
            "angles": angles.detach()}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else None, out=OUT)
