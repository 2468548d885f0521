"""Screen-space gradients: d(pixel value)/d(screen x, y) (port of
redner_tpu/screen_gradient.py; reference visualize_screen_gradient,
pyredner/render_pytorch.py:983-1048, src/edge.cpp:765-773).

The continuous part is two forward-mode derivatives of the per-pixel
render w.r.t. the pixel jitter (torch.autograd.forward_ad; the ray queries
detach their rays, so the tangents stop at the discrete hit records as the
primal gradients do).  The discontinuous (silhouette) part scatters
primary-edge samples into their pixels; options.use_primary_edge_sampling
gates it.

On a card the whole function (every sample's two jvps and the primary-edge
scatter) replays a cached CUDA graph of its configuration (graphs.py, kind
"screen_gradient"; JAX runs it as one compiled scan): the dual tensors are
made inside the captured body, so a replay recomputes the tangents the
capture recorded, on the new scene tensors and seed.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

import redner_tpu_torch.sampler as sampler_mod
from redner_tpu_torch import graphs, timing
from redner_tpu_torch.edge import primary_edge_screen_gradient_image
from redner_tpu_torch.render import RenderOptions, render_sample
from redner_tpu_torch.scene import flatten_scene, scene_tensors


def screen_gradient_image(scene, options: RenderOptions, seed=0,
                          engine=None):
    """-> (vh, vw, 2, C) image of d(channel)/d(x_pixel) and
    d(channel)/d(y_pixel).  seed: an int (wrapped to 32 bits) or an
    integer tensor.  engine: see accel.intersect.  On a card the result
    is a fresh tensor from the configuration's graph; a CPU scene and
    graphs.disable() run it eagerly."""
    dev = scene.shapes[0].vertices.device
    with timing.entry("screen_gradient"):
        seed = sampler_mod._as_u32(seed, dev)
        if not graphs.replays(dev):
            return _screen_gradient(scene, options, seed, engine)
        prog = graphs.program(
            "screen_gradient", scene, options, None, engine,
            lambda s: graphs.Program(
                s, lambda sc, sd: _screen_gradient(sc, options, sd, engine)))
        return prog.forward(scene_tensors(scene), seed)


def _screen_gradient(scene, options, seed, engine):
    """The screen gradient of the scene at the int64 device seed: the body
    of both routes (the `fwd` phase)."""
    with timing.phase("fwd", seed.device):
        return _screen_gradient_body(scene, options, seed, engine)


def _screen_gradient_body(scene, options, seed, engine):
    fs = flatten_scene(scene)
    camera = scene.camera
    top, left, bottom, right = camera.viewport_or_full
    vw, vh = right - left, bottom - top
    n = vw * vh
    ci = options.channel_info
    dev, dtype = fs.device, fs.vertices.dtype
    pixel_ids = torch.arange(n, device=dev)
    total = torch.zeros((n, 2, ci.num_total_dimensions), dtype=dtype,
                        device=dev)
    with torch.no_grad():
        for sample_id in range(options.num_samples):
            if options.sample_pixel_center:
                jitter = torch.full((n, 2), 0.5, dtype=dtype, device=dev)
            else:
                jitter = sampler_mod.draw(options.sampler_type, seed,
                                          pixel_ids, sample_id, 0, 2)
            for axis in range(2):
                tangent = torch.zeros_like(jitter)
                tangent[:, axis] = 1.0
                with fwAD.dual_level():
                    out = render_sample(fs, camera, options, seed, sample_id,
                                        jitter=fwAD.make_dual(jitter, tangent),
                                        engine=engine)
                    d = fwAD.unpack_dual(out).tangent
                if d is not None:
                    total[:, axis] += d
        img = (total / options.num_samples).reshape(vh, vw, 2,
                                                    ci.num_total_dimensions)
        if options.use_primary_edge_sampling:
            num_edge_samples = (options.num_edge_samples
                                or n * options.num_samples)
            img = img + primary_edge_screen_gradient_image(
                scene, flatten_scene, render_sample, options, seed,
                num_edge_samples, img.shape, engine=engine)
    return img


def visualize_screen_gradient(scene, options: RenderOptions, seed=0,
                              engine=None):
    """Magnitude image of the screen gradient of the first channel
    (the reference visualize_screen_gradient's output shape)."""
    g = screen_gradient_image(scene, options, seed, engine=engine)
    return torch.linalg.norm(g[..., 0], dim=-1)
