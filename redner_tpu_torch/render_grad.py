"""`render`: the differentiable entry point with edge-sampled visibility
gradients (port of redner_tpu/render_grad.py).

A torch.autograd.Function whose forward is render_image and whose backward
sums three gradients of one re-render, taken by torch.autograd:

  1. the continuous gradients, by autograd through the re-render;
  2. the secondary-edge surrogate, fused into the re-render's bounce loop
     (render._render_image_impl with secondary_d_radiance), so each camera
     path is traced once (src/pathtracer.cpp:431-707);
  3. the primary-edge surrogate (edge.primary_edge_gradients).

The backward re-renders with the forward's RNG stream (correlated replay,
pyredner/render_pytorch.py:10-29); set_use_correlated_random_number(False)
switches to seed + 1.

RenderOptions.remat checkpoints each pass of the re-render
(render._render_image_impl): the backward then holds one pass's autograd
residuals at a time.  RenderOptions.isect_replay_max_mb is accepted and
changes nothing.  The JAX version keeps the forward's ray-query results
for the re-render; on the card that saved under 1% of a gradient's device
time and made the gradient no faster (PERF.md), so the re-render here runs
its ray queries again and gives the same gradient.

pixel_sharding (parallel.sharding.pixel_sharding) runs the forward, the
re-render with its secondary edges and the primary edges on this rank's
lanes; the backward then sums the leaves' gradients over the ranks in one
all-reduce, so every rank holds the one-process gradient.
"""

from __future__ import annotations

import torch

from redner_tpu_torch.core.shardutil import all_reduce_grads
from redner_tpu_torch.edge import primary_edge_gradients
from redner_tpu_torch.render import (RenderOptions, _render_image_impl,
                                     render_image, render_sample)
from redner_tpu_torch.scene import (flatten_scene, scene_leaves,
                                    scene_with_leaves)

_use_correlated = True


def set_use_correlated_random_number(v: bool):
    """Reference global (pyredner/render_pytorch.py:10-29)."""
    global _use_correlated
    _use_correlated = bool(v)


def get_use_correlated_random_number() -> bool:
    return _use_correlated


def default_num_edge_samples(options: RenderOptions, n_pix: int) -> int:
    """The primary-edge budget of one backward: a quarter of the backward's
    lane count, at least 16,384 and at most all of it."""
    full = n_pix * options.num_samples_backward
    return options.num_edge_samples or min(full, max(full // 4, 16384))


class _RenderFunction(torch.autograd.Function):
    """forward(scene, options, seed, correlated, engine, pixel_sharding,
    *leaves): the leaves are scene_leaves(scene), passed explicitly so
    autograd sees them; the scene supplies the structure."""

    @staticmethod
    def forward(ctx, scene, options, seed, correlated, engine,
                pixel_sharding, *leaves):
        ctx.scene = scene
        ctx.options = options
        ctx.seed = seed
        ctx.correlated = correlated
        ctx.engine = engine
        ctx.pixel_sharding = pixel_sharding
        ctx.save_for_backward(*leaves)
        return render_image(scene_with_leaves(scene, leaves), options,
                            seed=seed, engine=engine,
                            pixel_sharding=pixel_sharding)

    @staticmethod
    def backward(ctx, ct_img):
        options = ctx.options
        # The correlated flag is the one snapshotted when render was called.
        seed_b = ctx.seed if ctx.correlated else (ctx.seed + 1) & 0xFFFFFFFF
        options_b = options
        if options.num_samples_backward != options.num_samples:
            options_b = options._copy_with(
                num_samples=options.num_samples_backward)
        roff = options.channel_info.radiance_dimension
        use_secondary = options.use_secondary_edge_sampling and roff >= 0
        ct_img = ct_img.detach()
        sharding = ctx.pixel_sharding
        needs = ctx.needs_input_grad[6:]
        leaves = [x.detach().requires_grad_(n)
                  for x, n in zip(ctx.saved_tensors, needs)]
        top, left, bottom, right = ctx.scene.camera.viewport_or_full
        num_edge_samples = default_num_edge_samples(
            options, (right - left) * (bottom - top))
        with torch.enable_grad():
            s = scene_with_leaves(ctx.scene, leaves)
            if use_secondary:
                img, surr = _render_image_impl(
                    s, options_b, seed_b, ctx.engine,
                    secondary_d_radiance=ct_img[..., roff:roff + 3],
                    pixel_sharding=sharding)
            else:
                img = _render_image_impl(s, options_b, seed_b, ctx.engine,
                                         pixel_sharding=sharding)
                surr = torch.zeros((), dtype=ct_img.dtype,
                                   device=ct_img.device)
            if options.use_primary_edge_sampling:
                surr = surr + primary_edge_gradients(
                    s, flatten_scene, render_sample, options_b, seed_b,
                    ct_img, num_edge_samples, engine=ctx.engine,
                    lane_sharding=sharding)
            # <img, ct_img> + surrogate: what JAX's vjp((ct_img, 1)) gives.
            # Under a sharding each term is this rank's part of the sum.
            total = torch.sum(img * ct_img) + surr
            wrt = [x for x in leaves if x.requires_grad]
            grads = torch.autograd.grad(total, wrt, allow_unused=True)
        if sharding is not None:
            # Every rank passes the same leaves, so the pattern of unused
            # (None) gradients is the same on all of them.
            grads = all_reduce_grads(grads, sharding)
        grads = iter(grads)
        return (None,) * 6 + tuple(next(grads) if n else None for n in needs)


def render(scene, options: RenderOptions, seed=0, engine=None,
           pixel_sharding=None):
    """Differentiable render with edge-sampled visibility gradients: returns
    render_image(scene, options, seed); its backward gives every float
    tensor of the scene (scene_leaves) the reference's scene gradient.

    engine: None = the CUDA kernels on a card scene (plain versions on a
    CPU scene); "plain" (or its aliases "bruteforce" and "cluster") forces
    the plain ray queries.  pixel_sharding: see
    parallel.sharding.render_sharded."""
    return _RenderFunction.apply(scene, options, int(seed) & 0xFFFFFFFF,
                                 _use_correlated, engine, pixel_sharding,
                                 *scene_leaves(scene))
