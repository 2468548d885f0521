"""redner_tpu_torch.frontend — the pyredner-style torch front end over the
port (port of redner_torch/, module for module):

    import redner_tpu_torch.frontend as pyredner
    objects = pyredner.load_obj('teapot.obj', return_objects=True)
    camera = pyredner.automatic_camera_placement(objects, (256, 256))
    scene = pyredner.Scene(camera=camera, objects=objects)
    img = pyredner.render_pathtracing(scene, num_samples=16)
    img.sum().backward()   # grads land on every requires_grad tensor

The classes hold the user's tensors; every render builds the port's Scene
from them with differentiable ops and calls redner_tpu_torch.render, whose
backward gives the edge-sampled scene gradient.  Where redner_torch's
compute core is JAX and copies every leaf through numpy, this one runs on
the CUDA card (or on the CPU after set_device("cpu")) and nothing crosses
the host.  Objects made from lists or numpy arrays go to get_device().
"""

from redner_tpu_torch import camera_type, channels
from redner_tpu_torch.camera import CameraType
from redner_tpu_torch.channels import Channels
from redner_tpu_torch.device import get_device, set_device, use_gpu
from redner_tpu_torch.frontend.area_light import AreaLight
from redner_tpu_torch.frontend.camera import (Camera,
                                              automatic_camera_placement,
                                              generate_intrinsic_mat)
from redner_tpu_torch.frontend.envmap import EnvironmentMap
from redner_tpu_torch.frontend.geometry_images import generate_geometry_image
from redner_tpu_torch.frontend.image import imread, imwrite
from redner_tpu_torch.frontend.load_mitsuba import load_mitsuba
from redner_tpu_torch.frontend.load_obj import load_obj
from redner_tpu_torch.frontend.material import Material
from redner_tpu_torch.frontend.object import Object
from redner_tpu_torch.frontend.render_torch import (RenderFunction, render,
                                                    serialize_scene)
from redner_tpu_torch.frontend.render_utils import (AmbientLight,
                                                    DeferredLight,
                                                    DirectionalLight,
                                                    PointLight, SpotLight,
                                                    render_albedo,
                                                    render_deferred,
                                                    render_g_buffer,
                                                    render_generic,
                                                    render_pathtracing)
from redner_tpu_torch.frontend.save_obj import save_mtl, save_obj
from redner_tpu_torch.frontend.scene import Scene
from redner_tpu_torch.frontend.shape import (Shape, compute_uvs,
                                             compute_vertex_normal, smooth)
from redner_tpu_torch.frontend.texture import Texture
from redner_tpu_torch.frontend.transform import (gen_look_at_matrix,
                                                 gen_perspective,
                                                 gen_rotate_matrix,
                                                 gen_scale_matrix,
                                                 gen_translate_matrix)
from redner_tpu_torch.frontend.utils import (SH, SH_reconstruct,
                                             generate_quad_light,
                                             generate_sphere, linear_to_srgb,
                                             srgb_to_linear)
from redner_tpu_torch.render_grad import (get_use_correlated_random_number,
                                          set_use_correlated_random_number)
from redner_tpu_torch.sampler import SamplerType
from redner_tpu_torch.timing import (get_print_timing, profile_trace,
                                     set_print_timing, timed)

__version__ = "0.1.0"


class sampler_type:  # noqa: N801
    """The samplers, pyredner-style (pyredner/sampler_type.py)."""

    independent = SamplerType.independent
    sobol = SamplerType.sobol


__all__ = [
    "AmbientLight", "AreaLight", "Camera", "CameraType", "Channels",
    "DeferredLight", "DirectionalLight", "EnvironmentMap", "Material",
    "Object", "PointLight", "RenderFunction", "SH", "SH_reconstruct",
    "SamplerType", "Scene", "Shape", "SpotLight", "Texture",
    "automatic_camera_placement", "camera_type", "channels", "compute_uvs",
    "compute_vertex_normal", "gen_look_at_matrix", "gen_perspective",
    "gen_rotate_matrix", "gen_scale_matrix", "gen_translate_matrix",
    "generate_geometry_image", "generate_intrinsic_mat",
    "generate_quad_light", "generate_sphere", "get_device",
    "get_print_timing", "get_use_correlated_random_number", "imread",
    "imwrite", "linear_to_srgb", "load_mitsuba", "load_obj",
    "profile_trace", "render", "render_albedo", "render_deferred",
    "render_g_buffer", "render_generic", "render_pathtracing", "sampler_type",
    "save_mtl", "save_obj", "serialize_scene", "set_device",
    "set_print_timing", "set_use_correlated_random_number", "smooth",
    "srgb_to_linear", "timed", "use_gpu",
]
