"""High-level render entry points of the torch front end (port of
redner_torch/render_utils.py; reference pyredner/render_utils.py).

Each takes a front-end Scene or a list of them.  A list renders to a
stacked (B, H, W, C) tensor, scene i with seed[i] when `seed` is a list
(one per scene; a wrong count raises ValueError) or with seed + i.  A
single scene is built (Scene._build) and handed to the port's entry point
of the same name, so the G-buffer runs through redner_tpu_torch.render
and the deferred lights shade it in torch.

The deferred lights are the port's (redner_tpu_torch.render_utils), which
shade with the Lambertian albedo / pi of pyredner/render_utils.py;
redner_torch's point, directional and spot lights leave out the 1 / pi.
"""

from __future__ import annotations

from typing import Sequence

import torch

import redner_tpu_torch as rtt
from redner_tpu_torch.render_utils import (AmbientLight,  # noqa: F401
                                           DeferredLight, DirectionalLight,
                                           PointLight, SpotLight)


def _batch_seeds(seed, n: int):
    """Reference semantics (pyredner/render_utils.py:139): one seed per
    scene, or seed + i."""
    if isinstance(seed, (list, tuple)):
        if len(seed) != n:
            raise ValueError(
                f"batch render got {n} scenes but {len(seed)} seeds")
        return list(seed)
    return [seed + i for i in range(n)]


def _each(render_one, scene, seed, per_scene=None):
    """render_one(scene, seed) for one scene; a stack for a list, with
    per_scene[i] passed to scene i when given."""
    if not isinstance(scene, (list, tuple)):
        return render_one(scene, seed)
    seeds = _batch_seeds(seed, len(scene))
    if per_scene is None:
        return torch.stack([render_one(s, sd) for s, sd in zip(scene, seeds)])
    return torch.stack([render_one(s, sd, x)
                        for s, sd, x in zip(scene, seeds, per_scene)])


def render_g_buffer(scene, channels: Sequence[rtt.Channels],
                    num_samples: int = 1, max_bounces: int = 0,
                    sample_pixel_center: bool = False,
                    sampler_type=rtt.SamplerType.sobol, seed=0):
    return _each(lambda s, sd: rtt.render_g_buffer(
        s._build(), channels, num_samples=num_samples,
        max_bounces=max_bounces, sample_pixel_center=sample_pixel_center,
        sampler_type=sampler_type, seed=sd), scene, seed)


def render_deferred(scene, lights: Sequence[DeferredLight],
                    alpha: bool = False, aa_samples: int = 2, seed=0):
    """Lights may be one list shared by every scene of a batch or one list
    per scene (reference pyredner/render_utils.py:267)."""
    per_scene = None
    if isinstance(scene, (list, tuple)):
        per_scene = (lights if lights and isinstance(lights[0], (list, tuple))
                     else [lights] * len(scene))
    return _each(lambda s, sd, ls=lights: rtt.render_deferred(
        s._build(), ls, alpha=alpha, aa_samples=aa_samples, seed=sd),
        scene, seed, per_scene)


def render_albedo(scene, alpha: bool = False, num_samples: int = 16,
                  seed=0):
    channels = [rtt.Channels.diffuse_reflectance]
    if alpha:
        channels.append(rtt.Channels.alpha)
    return render_g_buffer(scene, channels, num_samples=num_samples,
                           seed=seed)


def render_pathtracing(scene, alpha: bool = False, max_bounces: int = 1,
                       sampler_type=rtt.SamplerType.sobol,
                       num_samples: int = 4, seed=0):
    channels = [rtt.Channels.radiance]
    if alpha:
        channels.append(rtt.Channels.alpha)
    return render_g_buffer(scene, channels, num_samples=num_samples,
                           max_bounces=max_bounces, sampler_type=sampler_type,
                           seed=seed)


def render_generic(scene, channels: Sequence[rtt.Channels],
                   max_bounces: int = 1, sampler_type=rtt.SamplerType.sobol,
                   num_samples: int = 4, sample_pixel_center: bool = False,
                   seed=0):
    return render_g_buffer(scene, channels, num_samples=num_samples,
                           max_bounces=max_bounces,
                           sample_pixel_center=sample_pixel_center,
                           sampler_type=sampler_type, seed=seed)
