"""TorchRenderer: the JAX package's bridge class for torch training loops
(port of redner_tpu/torch_bridge.py), kept so that code written against it
runs on the port unchanged.

The JAX package's class wraps its renderer in a torch.autograd.Function
whose tensors cross to JAX and back through numpy.  The port is torch
throughout, so nothing crosses: the parameters go into the scene as they
are and the port's edge-sampled `render` differentiates them.  As there,
nothing of a forward's work outlives it but the inputs of the backward's
re-render (render saves the scene's tensors and the seed).

Usage:
    render = TorchRenderer(options, param_setter, seed=0)
    img = render(scene_template, vertices, diffuse)
"""

from __future__ import annotations

from typing import Callable

from redner_tpu_torch.render_grad import render


class TorchRenderer:
    """Differentiable bridge: torch tensors in, the image out.

    `param_setter(scene_template, *params) -> scene` places the parameters
    in the scene; each parameter goes to the template's device first (a
    differentiable copy, so its gradient comes back on its own device),
    and the image comes back on the first parameter's device, as the JAX
    package's class returns it."""

    def __init__(self, options, param_setter: Callable, seed: int = 0):
        self.options = options
        self.param_setter = param_setter
        self.seed = seed

    def render(self, scene_template, *params):
        """rtt.render(param_setter(scene_template, *params), options,
        seed)."""
        dev = scene_template.shapes[0].vertices.device
        scene = self.param_setter(scene_template,
                                  *(p.to(dev) for p in params))
        img = render(scene, self.options, seed=self.seed)
        return img.to(params[0].device) if params else img

    __call__ = render
