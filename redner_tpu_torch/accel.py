"""Ray-casting queries: closest hit and any hit (port of
redner_tpu/accel.py).

The contract mirrors the reference's intersect()/occluded()
(src/scene.h:116-130): discrete (tri_id, shape_id) records and a detached
t that the renderer treats as non-differentiable; the differentiable
surface point is re-derived from the winning triangle.

The default engine lays the rays out once (ops/intersect_cuda.prepare_rays),
runs one sweep and maps the result back (finish_closest / finish_anyhit).
The sweep is the kernel wrapper, which launches the hand-written kernel on
CUDA tensors (a failed build or launch raises) and runs the plain PyTorch
version on CPU tensors.  engine="plain" forces the plain version on either
device; it exists for holding the kernels against their plain versions and
is never taken implicitly.  "bruteforce" and "cluster" (redner_tpu's
chunked sweep and Morton-clustered engines) are accepted for API parity and
run the plain version: they return the same hits, and ported as written
they were 33-196x slower per query than the kernels on an H100 (PERF.md).

`precise` is accepted for API parity and ignored: on Hopper every
precision mode of the TPU kernel is the same exact-f32 path.

Each query is the `isect.closest` / `isect.any` phase (timing.phase): the
launcher's layout, mask and work list, the kernel and the epilogue.
"""

from __future__ import annotations

from redner_tpu_torch import timing
from redner_tpu_torch.core.types import Intersection, Ray
from redner_tpu_torch.ops import intersect as plain
from redner_tpu_torch.ops import intersect_cuda as ic

ENGINES = (None, "plain", "bruteforce", "cluster")


def _is_plain(engine) -> bool:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    return engine is not None


def intersect(fs, ray: Ray, presorted: bool = False, precise=False,
              engine=None) -> Intersection:
    """Closest hit per ray.  presorted: the caller guarantees a
    tile-coherent ray order, so the Morton ray sort is skipped."""
    with timing.phase("isect.closest", fs.device):
        rb = ic.prepare_rays(fs, ray, presorted)
        if _is_plain(engine):
            best_t, best_i = plain.closest_plain(fs.layout.Tc, rb)
        else:
            best_t, best_i = ic.closest_hit(fs.layout, rb)
        return ic.finish_closest(fs, rb, best_t, best_i)


def occluded(fs, ray: Ray, presorted: bool = False, precise=False,
             engine=None):
    """True where the segment (tmin, tmax) of a ray is blocked."""
    with timing.phase("isect.any", fs.device):
        rb = ic.prepare_rays(fs, ray, presorted)
        if _is_plain(engine):
            blocked, _ = plain.anyhit_plain(fs.layout.Tc, rb)
        else:
            blocked = ic.any_hit(fs.layout, rb)
        return ic.finish_anyhit(rb, blocked)
