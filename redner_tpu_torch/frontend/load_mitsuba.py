"""Mitsuba XML scenes as front-end Scenes (port of
redner_torch/load_mitsuba.py; reference pyredner/load_mitsuba.py)."""

from __future__ import annotations

from redner_tpu_torch.device import resolve_device
from redner_tpu_torch.frontend._convert import scene_from_port
from redner_tpu_torch.io.mitsuba import load_mitsuba as _load_mitsuba


def load_mitsuba(filename: str):
    """Parse a Mitsuba scene XML onto the default device; loaded meshes keep
    their load-time weld maps."""
    return scene_from_port(_load_mitsuba(filename,
                                         device=resolve_device(None)))
