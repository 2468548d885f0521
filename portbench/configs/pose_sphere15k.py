"""pose_sphere15k's scenes (run.load_config): a glossy UV sphere on a
floor under a quad light, built for both sides by portbench/scenes.py,
rendered by the reference with reference/plain.py and, where the
traffic turns the samplers on, reference/edges.py's edge terms."""

import torch

from portbench import scenes
from portbench.reference import edges, plain

build_scene = scenes.build_scene
build_reference = scenes.build_plain
LEAVES = scenes.LEAVES
REFERENCE_LEAVES = scenes.PLAIN_LEAVES
perturbed = scenes.perturbed
posed = scenes.posed
posed_reference = scenes.posed_plain
render_reference = plain.render
EDGES = edges


def move_reference_camera(scene, position):
    scene.camera.position.copy_(torch.as_tensor(position))


def tiny(cfg):
    """The sphere at 6 x 12 steps."""
    cfg["sphere"]["theta_steps"], cfg["sphere"]["phi_steps"] = 6, 12
    return cfg
