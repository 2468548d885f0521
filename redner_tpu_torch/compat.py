"""pyredner names for reference scripts (port of redner_tpu/compat.py):
`import redner_tpu_torch.compat as pyredner`.

The port has one pyredner surface, the torch front end
(redner_tpu_torch.frontend), and this module re-exports it: `Camera`,
`Shape`, `Scene`, `serialize_scene`, `RenderFunction`, `render` and the
rest are the front end's own.  redner_tpu.compat puts pyredner's names over
JAX pytrees; here the front end's classes already hold the user's torch
tensors, and gradients come from `.backward()` on them.

Differences from redner_tpu.compat, whose names return the functional
API's pytrees:
  * `serialize_scene` returns pyredner's list [scene args, *tensors], not
    (scene, RenderOptions); `RenderFunction.apply(seed, args)` and
    `RenderFunction.apply(seed, *args)` both take it;
  * `render(scene, num_samples=..., max_bounces=..., seed=...)` takes the
    render options as keywords, as pyredner.render does;
  * the classes are redner_torch's: `scene.shapes[0].vertices` is the
    tensor the user gave;
  * `visualize_screen_gradient` takes a front-end Scene.
"""

from redner_tpu_torch.frontend import *  # noqa: F401,F403
from redner_tpu_torch.frontend import __all__ as _frontend_all
from redner_tpu_torch.render import RenderOptions
from redner_tpu_torch.screen_gradient import \
    visualize_screen_gradient as _visualize_screen_gradient


def visualize_screen_gradient(scene, seed=0, **options):
    """Magnitude image of the screen gradient of a front-end Scene
    (options: RenderOptions fields)."""
    return _visualize_screen_gradient(scene._build(),
                                      RenderOptions(**options), seed=seed)


__all__ = list(_frontend_all) + ["visualize_screen_gradient"]
