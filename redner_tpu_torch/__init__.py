"""redner_tpu_torch: the PyTorch + CUDA port of redner_tpu, a differentiable
Monte Carlo path tracer (Li et al. 2018, "Differentiable Monte Carlo Ray
Tracing through Edge Sampling").

Ported so far: the forward render (`render_image`) on a perspective camera,
triangle meshes with constant or mipmapped image-texture materials (the
MaterialBank) and normal maps, area lights, a lat-long environment map and
the independent sampler, with every ray query on two hand-written CUDA kernels
(ops/intersect_cuda.py, csrc/intersect.cu); and `render`, a
torch.autograd.Function whose backward adds primary and secondary edge
sampling (the visibility gradients) to the continuous ones.  torch.autograd
through `render_image` alone gives only the continuous gradients.

Entry points run on the CUDA card unless given device="cpu"; the CPU path
uses the kernels' plain PyTorch versions.  This package imports neither
JAX nor redner_tpu.
"""

from redner_tpu_torch.device import resolve_device, set_numerics

set_numerics()

from redner_tpu_torch.camera import Camera, CameraType, make_camera  # noqa: E402
from redner_tpu_torch.channels import ChannelInfo, Channels  # noqa: E402
from redner_tpu_torch.convert import scene_from_arrays  # noqa: E402
from redner_tpu_torch.envmap import (EnvironmentMap,  # noqa: E402
                                     make_environment_map)
from redner_tpu_torch.geometry import Shape, make_shape  # noqa: E402
from redner_tpu_torch.light import AreaLight, make_area_light  # noqa: E402
from redner_tpu_torch.material import Material, make_material  # noqa: E402
from redner_tpu_torch.object import Object, scene_from_objects  # noqa: E402
from redner_tpu_torch.render import RenderOptions, render_image  # noqa: E402
from redner_tpu_torch.render_grad import (  # noqa: E402
    get_use_correlated_random_number, render, set_use_correlated_random_number)
from redner_tpu_torch.sampler import SamplerType  # noqa: E402
from redner_tpu_torch.scene import Scene, flatten_scene, make_scene  # noqa: E402
from redner_tpu_torch.texture import Texture, make_texture  # noqa: E402
from redner_tpu_torch.utils import (generate_quad_light,  # noqa: E402
                                    generate_sphere)

__all__ = [
    "AreaLight", "Camera", "CameraType", "ChannelInfo", "Channels",
    "EnvironmentMap", "Material", "Object", "RenderOptions", "SamplerType",
    "Scene", "Shape", "Texture", "flatten_scene", "generate_quad_light",
    "generate_sphere", "make_area_light", "make_camera",
    "make_environment_map", "make_material", "make_scene",
    "make_shape", "make_texture", "get_use_correlated_random_number",
    "render", "render_image", "resolve_device", "scene_from_arrays",
    "scene_from_objects", "set_use_correlated_random_number",
]
