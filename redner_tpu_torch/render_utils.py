"""High-level rendering helpers: deferred shading, G-buffers, albedo,
path tracing (port of redner_tpu/render_utils.py; reference
pyredner/render_utils.py).

The deferred pipeline renders a G-buffer with the differentiable core
(`render`, so the primary-edge gradients come with it) and shades it with
analytic lights in torch ops; gradients flow through both stages.  Every
entry point defaults to the Sobol sampler, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Union

import torch

from redner_tpu_torch.channels import Channels
from redner_tpu_torch.core import vecmath as vm
from redner_tpu_torch.render import RenderOptions
from redner_tpu_torch.render_grad import render as _render
from redner_tpu_torch.sampler import SamplerType
from redner_tpu_torch.scene import Scene


def _like(x, ref):
    """x as a tensor on ref's dtype and device (a tensor that already is
    keeps its autograd history)."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


class DeferredLight:
    pass


class AmbientLight(DeferredLight):
    """(reference pyredner/render_utils.py:11-22)"""

    def __init__(self, intensity):
        self.intensity = intensity

    def render(self, position, normal, albedo):
        return _like(self.intensity, albedo) * albedo


class PointLight(DeferredLight):
    """Point light with inverse-square falloff
    (reference pyredner/render_utils.py:24-41)."""

    def __init__(self, position, intensity):
        self.position = position
        self.intensity = intensity

    def render(self, position, normal, albedo):
        d = _like(self.position, position) - position
        dist_sq = torch.sum(d * d, dim=-1, keepdim=True)
        d = d / torch.sqrt(vm.maximum(dist_sq, 1e-20))
        cos = vm.maximum(torch.sum(normal * d, dim=-1, keepdim=True), 0.0)
        return (_like(self.intensity, albedo) * cos * (albedo / math.pi)
                / vm.maximum(dist_sq, 1e-20))


class DirectionalLight(DeferredLight):
    """(reference pyredner/render_utils.py:43-58)"""

    def __init__(self, direction, intensity):
        self.direction = direction
        self.intensity = intensity

    def render(self, position, normal, albedo):
        direction = _like(self.direction, normal)
        d = -direction / torch.linalg.norm(direction)
        cos = vm.maximum(torch.sum(normal * d, dim=-1, keepdim=True), 0.0)
        return _like(self.intensity, albedo) * cos * (albedo / math.pi)


class SpotLight(DeferredLight):
    """(reference pyredner/render_utils.py:60-103)"""

    def __init__(self, position, spot_direction, spot_exponent, intensity):
        self.position = position
        self.spot_direction = spot_direction
        self.spot_exponent = spot_exponent
        self.intensity = intensity

    def render(self, position, normal, albedo):
        d = _like(self.position, position) - position
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        spot_dir = _like(self.spot_direction, position)
        cos_angle = torch.sum(spot_dir / torch.linalg.norm(spot_dir) * d,
                              dim=-1, keepdim=True)
        spot = vm.maximum(cos_angle, 0.0) ** _like(self.spot_exponent,
                                                   position)
        cos = vm.maximum(torch.sum(normal * d, dim=-1, keepdim=True), 0.0)
        return _like(self.intensity, albedo) * spot * cos * (albedo / math.pi)


def _area_downsample(img, aa: int):
    """Average aa x aa blocks (the reference downsamples with area
    interpolation, pyredner/render_utils.py:203-213)."""
    if aa <= 1:
        return img
    h, w, c = img.shape
    return img.reshape(h // aa, aa, w // aa, aa, c).mean(dim=(1, 3))


def _upscaled_camera(camera, aa: int):
    """The camera at aa times the resolution (and viewport), its intrinsics
    and distortion kept."""
    if aa <= 1:
        return camera
    h, w = camera.resolution
    vp = camera.viewport
    if vp is not None:
        vp = tuple(v * aa for v in vp)
    return dataclasses.replace(camera, resolution=(h * aa, w * aa),
                               viewport=vp)


def render_g_buffer(
    scene: Scene,
    channels: Sequence[Channels],
    num_samples: int = 1,
    max_bounces: int = 0,
    sample_pixel_center: bool = False,
    sampler_type: SamplerType = SamplerType.sobol,
    seed: int = 0,
    engine=None,
):
    """Render arbitrary AOV channels (reference render_g_buffer,
    pyredner/render_utils.py:431-503).  engine: see accel.intersect (every
    entry point here takes it)."""
    options = RenderOptions(
        num_samples=num_samples,
        max_bounces=max_bounces,
        channels=tuple(channels),
        sampler_type=sampler_type,
        sample_pixel_center=sample_pixel_center,
    )
    return _render(scene, options, seed=seed, engine=engine)


def render_deferred(
    scene: Scene,
    lights: Sequence[DeferredLight],
    alpha: bool = False,
    aa_samples: int = 2,
    seed: int = 0,
    engine=None,
):
    """G-buffer + deferred shading with supersampled antialiasing
    (reference render_deferred, pyredner/render_utils.py:104-313)."""
    camera = _upscaled_camera(scene.camera, aa_samples)
    scene_up = dataclasses.replace(scene, camera=camera)
    channels = [Channels.position, Channels.shading_normal,
                Channels.diffuse_reflectance]
    if alpha:
        channels.append(Channels.alpha)
    g = render_g_buffer(scene_up, channels, num_samples=1, max_bounces=0,
                        seed=seed, engine=engine)
    pos = g[..., 0:3]
    normal = g[..., 3:6]
    albedo = g[..., 6:9]
    img = torch.zeros_like(albedo)
    for light in lights:
        img = img + light.render(pos, normal, albedo)
    if alpha:
        img = torch.cat([img, g[..., 9:10]], dim=-1)
    return _area_downsample(img, aa_samples)


def render_albedo(
    scene: Union[Scene, List[Scene]],
    alpha: bool = False,
    num_samples: int = 16,
    seed: int = 0,
    engine=None,
):
    """Diffuse-reflectance pass (reference render_albedo,
    pyredner/render_utils.py:576-631); a list of scenes gives a stack,
    scene i at seed + i."""
    channels = [Channels.diffuse_reflectance]
    if alpha:
        channels.append(Channels.alpha)
    if isinstance(scene, (list, tuple)):
        return torch.stack([
            render_g_buffer(s, channels, num_samples=num_samples,
                            seed=seed + i, engine=engine)
            for i, s in enumerate(scene)
        ])
    return render_g_buffer(scene, channels, num_samples=num_samples,
                           seed=seed, engine=engine)


def render_pathtracing(
    scene: Union[Scene, List[Scene]],
    alpha: bool = False,
    max_bounces: int = 1,
    sampler_type: SamplerType = SamplerType.sobol,
    num_samples: int = 4,
    seed: int = 0,
    engine=None,
):
    """Full path tracing (reference render_pathtracing,
    pyredner/render_utils.py:505-574); a list of scenes gives a stack."""
    channels = [Channels.radiance]
    if alpha:
        channels.append(Channels.alpha)
    if isinstance(scene, (list, tuple)):
        return torch.stack([
            render_g_buffer(s, channels, num_samples=num_samples,
                            max_bounces=max_bounces,
                            sampler_type=sampler_type, seed=seed + i,
                            engine=engine)
            for i, s in enumerate(scene)
        ])
    return render_g_buffer(scene, channels, num_samples=num_samples,
                           max_bounces=max_bounces, sampler_type=sampler_type,
                           seed=seed, engine=engine)


def render_generic(
    scene: Scene,
    channels: Sequence[Channels],
    max_bounces: int = 1,
    sampler_type: SamplerType = SamplerType.sobol,
    num_samples: int = 4,
    sample_pixel_center: bool = False,
    seed: int = 0,
    engine=None,
):
    """Fully general entry point (reference render_generic,
    pyredner/render_utils.py:315-429)."""
    return render_g_buffer(scene, channels, num_samples=num_samples,
                           max_bounces=max_bounces,
                           sample_pixel_center=sample_pixel_center,
                           sampler_type=sampler_type, seed=seed,
                           engine=engine)
