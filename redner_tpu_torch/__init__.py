"""redner_tpu_torch: the PyTorch + CUDA port of redner_tpu, a differentiable
Monte Carlo path tracer (Li et al. 2018, "Differentiable Monte Carlo Ray
Tracing through Edge Sampling").

Ported so far: the forward render (`render_image`) under perspective,
orthographic, fisheye and panorama cameras with optional lens distortion,
triangle meshes with constant or mipmapped image-texture materials (the
MaterialBank), normal maps and generic textures, area lights, a lat-long
environment map, the independent and Sobol samplers and all 16 AOV
channels, with every ray query on two hand-written CUDA kernels
(ops/intersect_cuda.py, csrc/intersect.cu) and every per-lane row fetch of
a float table (face rows, materials, light intensities) and its
scatter-add backward on two more (ops/gather_cuda.py, csrc/gather.cu);
`render`, a
torch.autograd.Function whose backward adds primary and secondary edge
sampling (the visibility gradients) to the continuous ones; the screen
gradient (`screen_gradient_image`); and the pyredner-style utilities
(`render_g_buffer`, `render_deferred`, `render_albedo`,
`render_pathtracing`, `render_generic`, spherical harmonics, sRGB); scenes
from files (`load_obj`, `load_mitsuba`, `load_serialized`, EXR through
`imread`/`imwrite`) with load-time welds, the mesh helpers and scene
checkpoints (`save_scene`/`load_scene`); remat
(`RenderOptions(remat=True)`) on the edge-sampled backward
(`isect_replay_max_mb` is accepted and changes nothing); the device and
timing helpers (`set_device`, `set_print_timing`, `timed`,
`profile_trace`); rendering and training over several GPUs
(`redner_tpu_torch.parallel.sharding`, one process per card over
torch.distributed); `RenderOptions(split_shadow_sweep=False)` and the
`bruteforce` and `cluster` engines are accepted and run the split sweep
and the plain queries; the compiled render: on a card, `render`,
`render_image` (with or without autograd), `screen_gradient_image` and the
sharded entry points over NCCL replay cached CUDA graphs (`graphs.py`);
`make_render` gives the eager function and `graphs.disable()` runs every
entry point eagerly; the graph cache is bounded by the device memory its
graphs keep (`graphs.cached_bytes()`), and a key whose graphs do not fit
runs eagerly.  torch.autograd through `render_image` alone gives only the
continuous gradients.

Second derivatives: `torch.autograd.grad(..., create_graph=True)` through
`render` or `render_image` gives a gradient with history, as JAX's
reverse-over-reverse does (the backward is differentiated through the
saved scene tensors and the incoming gradient; the image that the
recorded gradient depends on is differentiated continuously, as JAX
differentiates a custom_vjp's forward), with or without a pixel
sharding over a process group (the ranks' collectives are differentiable,
core/shardutil.py): every rank holds the one-process second derivative.
`TorchRenderer` (torch_bridge.py) keeps the JAX package's bridge class:
render(scene_template, *params) renders param_setter(template, *params).

The pyredner-style front end sits on top: `redner_tpu_torch.frontend`
(`import redner_tpu_torch.frontend as pyredner`: redner_torch's classes,
which hold the user's tensors and build a Scene for every render);
`redner_tpu_torch.compat` re-exports it.

Entry points run on the CUDA card unless given device="cpu" or after
set_device("cpu"); the CPU path uses the kernels' plain PyTorch versions.
This package imports neither JAX nor redner_tpu.
"""

from redner_tpu_torch.device import (get_device, resolve_device,
                                     set_device, set_numerics, use_gpu)

__version__ = "0.1.0"

set_numerics()

from redner_tpu_torch.camera import (Camera, CameraType,  # noqa: E402
                                     automatic_camera_placement,
                                     generate_intrinsic_mat, make_camera)
from redner_tpu_torch.channels import ChannelInfo, Channels  # noqa: E402
from redner_tpu_torch.convert import scene_from_arrays  # noqa: E402
from redner_tpu_torch.core.types import (Intersection, Ray,  # noqa: E402
                                         RayDifferential, SurfacePoint)
from redner_tpu_torch.envmap import (EnvironmentMap,  # noqa: E402
                                     make_environment_map)
from redner_tpu_torch.geometry import (Shape, bound_vertices,  # noqa: E402
                                       compute_uvs, compute_vertex_normal,
                                       make_shape, smooth)
from redner_tpu_torch.geometry_images import (  # noqa: E402
    generate_geometry_image)
from redner_tpu_torch.io import (imread, imwrite, load_mitsuba,  # noqa: E402
                                 load_obj, load_serialized, save_mtl,
                                 save_obj)
from redner_tpu_torch.light import AreaLight, make_area_light  # noqa: E402
from redner_tpu_torch.material import Material, make_material  # noqa: E402
from redner_tpu_torch.meshops import load_obj_fast, weld_mesh  # noqa: E402
from redner_tpu_torch.object import Object, scene_from_objects  # noqa: E402
from redner_tpu_torch.render import RenderOptions, render_image  # noqa: E402
from redner_tpu_torch.render_grad import (  # noqa: E402
    get_use_correlated_random_number, make_render, render,
    set_use_correlated_random_number)
from redner_tpu_torch.render_utils import (AmbientLight,  # noqa: E402
                                           DeferredLight,
                                           DirectionalLight, PointLight,
                                           SpotLight, render_albedo,
                                           render_deferred, render_g_buffer,
                                           render_generic, render_pathtracing)
from redner_tpu_torch.sampler import SamplerType  # noqa: E402
from redner_tpu_torch.scene import (FlatScene, Scene,  # noqa: E402
                                    flatten_scene, make_scene)
from redner_tpu_torch.screen_gradient import (  # noqa: E402
    screen_gradient_image, visualize_screen_gradient)
from redner_tpu_torch.serialize import (load_scene,  # noqa: E402
                                        load_state_dict, save_scene,
                                        state_dict)
from redner_tpu_torch.texture import Texture, make_texture  # noqa: E402
from redner_tpu_torch.timing import (get_print_timing,  # noqa: E402
                                     profile_trace, set_print_timing, timed)
from redner_tpu_torch.torch_bridge import TorchRenderer  # noqa: E402
from redner_tpu_torch.utils import (generate_quad_light,  # noqa: E402
                                    generate_sphere, linear_to_srgb,
                                    sh_basis, sh_eval, sh_reconstruct,
                                    srgb_to_linear)



class camera_type:  # noqa: N801
    """The camera types, pyredner-style (pyredner/camera_type.py)."""

    perspective = CameraType.perspective
    orthographic = CameraType.orthographic
    fisheye = CameraType.fisheye
    panorama = CameraType.panorama


class channels:  # noqa: N801
    """The AOV channels, pyredner-style (pyredner/channels.py)."""

    radiance = Channels.radiance
    alpha = Channels.alpha
    depth = Channels.depth
    position = Channels.position
    geometry_normal = Channels.geometry_normal
    shading_normal = Channels.shading_normal
    uv = Channels.uv
    barycentric_coordinates = Channels.barycentric_coordinates
    diffuse_reflectance = Channels.diffuse_reflectance
    specular_reflectance = Channels.specular_reflectance
    roughness = Channels.roughness
    generic_texture = Channels.generic_texture
    vertex_color = Channels.vertex_color
    shape_id = Channels.shape_id
    triangle_id = Channels.triangle_id
    material_id = Channels.material_id


__all__ = [
    "AmbientLight", "AreaLight", "Camera", "CameraType", "ChannelInfo",
    "Channels", "DeferredLight", "DirectionalLight", "EnvironmentMap",
    "FlatScene", "Intersection", "Material", "Object", "PointLight", "Ray",
    "RayDifferential", "RenderOptions", "SamplerType", "Scene", "Shape",
    "SpotLight", "SurfacePoint", "Texture", "automatic_camera_placement",
    "bound_vertices", "camera_type", "channels", "compute_uvs",
    "compute_vertex_normal", "flatten_scene", "generate_geometry_image",
    "generate_intrinsic_mat", "generate_quad_light", "generate_sphere",
    "get_device", "get_print_timing", "get_use_correlated_random_number",
    "imread", "imwrite", "linear_to_srgb", "load_mitsuba", "load_obj",
    "load_obj_fast", "load_scene", "load_serialized", "load_state_dict",
    "make_area_light", "make_camera", "make_environment_map",
    "make_render",
    "make_material", "make_scene", "make_shape", "make_texture",
    "profile_trace", "render", "render_albedo", "render_deferred",
    "render_g_buffer", "render_generic", "render_image",
    "render_pathtracing", "resolve_device", "save_mtl", "save_obj",
    "save_scene", "scene_from_arrays", "scene_from_objects",
    "screen_gradient_image", "set_device", "set_print_timing",
    "set_use_correlated_random_number", "sh_basis", "sh_eval",
    "sh_reconstruct", "smooth", "srgb_to_linear", "state_dict", "timed",
    "use_gpu", "visualize_screen_gradient", "weld_mesh",
]
