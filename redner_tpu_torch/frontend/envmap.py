"""Environment map of the torch front end (port of
redner_torch/envmap.py; reference pyredner/envmap.py)."""

from __future__ import annotations

import redner_tpu_torch as rtt
from redner_tpu_torch.frontend._tensor import _as_tensor
from redner_tpu_torch.frontend.texture import Texture


class EnvironmentMap:
    """Lat-long radiance map; its texels and env_to_world are
    differentiable leaves."""

    def __init__(self, values, env_to_world=None, directly_visible=True):
        self.values = values if isinstance(values, Texture) else \
            Texture(values)
        self.env_to_world = _as_tensor(
            env_to_world if env_to_world is not None
            else [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
                  [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
        self.directly_visible = bool(directly_visible)

    def _build(self, dev) -> rtt.EnvironmentMap:
        return rtt.make_environment_map(
            self.values._build(dev), env_to_world=self.env_to_world,
            directly_visible=self.directly_visible, device=dev)
