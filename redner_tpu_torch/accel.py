"""Ray-casting queries: closest hit and any hit (port of
redner_tpu/accel.py:198-242).

The contract mirrors the reference's intersect()/occluded()
(src/scene.h:116-130): discrete (tri_id, shape_id) records and a detached
t that the renderer treats as non-differentiable; the differentiable
surface point is re-derived from the winning triangle.

Each query lays the rays out once (ops/intersect_cuda.prepare_rays), runs
one sweep and maps the result back (finish_closest / finish_anyhit).  The
sweep is the kernel wrapper, which launches the hand-written kernel on CUDA
tensors (a failed build or launch raises) and runs the plain PyTorch
version on CPU tensors.  engine="plain" forces the plain version on either
device; it exists for holding the kernels against their plain versions and
is never taken implicitly.

`precise` is accepted for API parity and ignored: on Hopper every
precision mode of the TPU kernel is the same exact-f32 path.
"""

from __future__ import annotations

from redner_tpu_torch.core.types import Intersection, Ray
from redner_tpu_torch.ops import intersect as plain
from redner_tpu_torch.ops import intersect_cuda as ic

ENGINES = (None, "plain")


def _check_engine(engine):
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")


def intersect(fs, ray: Ray, presorted: bool = False, precise=False,
              engine=None) -> Intersection:
    """Closest hit per ray.  presorted: the caller guarantees a
    tile-coherent ray order, so the Morton ray sort is skipped."""
    _check_engine(engine)
    rb = ic.prepare_rays(fs, ray, presorted)
    sweep = plain.closest_plain if engine == "plain" else ic.closest_hit
    best_t, best_i = sweep(fs.layout.Tc, rb)
    return ic.finish_closest(fs, rb, best_t, best_i)


def occluded(fs, ray: Ray, presorted: bool = False, precise=False,
             engine=None):
    """True where the segment (tmin, tmax) of a ray is blocked."""
    _check_engine(engine)
    rb = ic.prepare_rays(fs, ray, presorted)
    sweep = plain.anyhit_plain if engine == "plain" else ic.any_hit
    blocked, _ = sweep(fs.layout.Tc, rb)
    return ic.finish_anyhit(rb, blocked)
