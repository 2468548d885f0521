"""Area light of the torch front end (port of redner_torch/area_light.py;
reference pyredner/area_light.py)."""

from __future__ import annotations

import redner_tpu_torch as rtt
from redner_tpu_torch.frontend._tensor import _as_tensor


class AreaLight:
    """Diffuse area emitter on a shape; intensity is a differentiable
    leaf."""

    def __init__(self, shape_id: int, intensity, two_sided: bool = False,
                 directly_visible: bool = True):
        self.shape_id = int(shape_id)
        self.intensity = _as_tensor(intensity)
        self.two_sided = bool(two_sided)
        self.directly_visible = bool(directly_visible)

    def _build(self, dev) -> rtt.AreaLight:
        return rtt.make_area_light(self.shape_id, self.intensity,
                                   two_sided=self.two_sided,
                                   directly_visible=self.directly_visible,
                                   device=dev)
