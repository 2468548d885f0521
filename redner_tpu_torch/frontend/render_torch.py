"""Render entry points of the torch front end (port of
redner_torch/render_torch.py; reference pyredner/render_pytorch.py).

    args = serialize_scene(scene, num_samples=..., max_bounces=...)
    img = RenderFunction.apply(seed, *args)

`serialize_scene` builds the port's Scene from the front-end scene's
tensors (Scene._build: differentiable ops only) and returns it with the
RenderOptions and the port scene's float tensors.  `RenderFunction.apply`
rebuilds the scene with the tensors it is given and returns
`redner_tpu_torch.render`, the one torch.autograd.Function on the path: its
backward (edge-sampled visibility gradients included) reaches every
front-end tensor that requires grad through those ops.  Nothing crosses
the host.

redner_torch bridges to a jitted JAX VJP, so it registers leaves
(`_LeafReg`), keys an executable cache on the scene's structure (`_freeze`,
`_bwd_cache`, `_BWD_CACHE_MAX`) and copies tensors through numpy.  The
port runs eagerly in torch and has none of these to port.
"""

from __future__ import annotations

import redner_tpu_torch as rtt
from redner_tpu_torch.scene import scene_leaves, scene_with_leaves
from redner_tpu_torch.timing import timed


class _SceneArgs:
    """The first serialized argument: the port's Scene (whose structure
    RenderFunction.apply keeps) and the RenderOptions."""

    def __init__(self, scene: rtt.Scene, options: rtt.RenderOptions):
        self.scene = scene
        self.options = options


def serialize_scene(
    scene,
    num_samples=4,
    max_bounces=1,
    channels=None,
    sampler_type=None,
    use_primary_edge_sampling: bool = True,
    use_secondary_edge_sampling: bool = True,
    sample_pixel_center: bool = False,
    **options,
):
    """Flatten a front-end Scene for RenderFunction.apply
    (reference pyredner.serialize_scene) -> [scene args, *float tensors].

    options: further RenderOptions fields (num_edge_samples, remat,
    isect_replay_max_mb, ...)."""
    with timed("scene construction"):
        port_scene = scene._build()
    opts = rtt.RenderOptions(
        num_samples=num_samples,
        max_bounces=max_bounces,
        channels=tuple(channels) if channels else (rtt.Channels.radiance,),
        sampler_type=(sampler_type if sampler_type is not None
                      else rtt.SamplerType.independent),
        sample_pixel_center=sample_pixel_center,
        use_primary_edge_sampling=use_primary_edge_sampling,
        use_secondary_edge_sampling=use_secondary_edge_sampling,
        **options,
    )
    return [_SceneArgs(port_scene, opts)] + scene_leaves(port_scene)


class RenderFunction:
    """pyredner.RenderFunction.apply(seed, *serialize_scene(...)): a plain
    class, not a second autograd.Function around redner_tpu_torch.render.
    The serialized list may also come as one argument,
    apply(seed, serialize_scene(...)), as redner_tpu.compat takes it."""

    @staticmethod
    def apply(seed, scene_args, *leaves):
        if isinstance(scene_args, (list, tuple)):
            scene_args, *leaves = scene_args
        scene = scene_args.scene
        if leaves:
            scene = scene_with_leaves(scene, leaves)
        with timed("forward pass"):
            return rtt.render(scene, scene_args.options, seed=int(seed))


def render(scene, num_samples=4, max_bounces=1, channels=None,
           sampler_type=None, seed=0, **kwargs):
    """One-call render of a front-end Scene -> image on the scene's device,
    differentiable w.r.t. every tensor of the scene that requires grad.
    kwargs: serialize_scene's (RenderOptions fields such as remat)."""
    args = serialize_scene(scene, num_samples=num_samples,
                           max_bounces=max_bounces, channels=channels,
                           sampler_type=sampler_type, **kwargs)
    return RenderFunction.apply(seed, *args)
