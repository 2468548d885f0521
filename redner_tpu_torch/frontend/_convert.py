"""The port's scene objects -> front-end classes (loader plumbing; port of
redner_torch/_convert.py).  Tensors are taken as they are (the loaders put
them on the default device); weld maps come across."""

from __future__ import annotations

import redner_tpu_torch as rtt
from redner_tpu_torch.frontend.area_light import AreaLight
from redner_tpu_torch.frontend.camera import Camera
from redner_tpu_torch.frontend.envmap import EnvironmentMap
from redner_tpu_torch.frontend.material import Material
from redner_tpu_torch.frontend.object import Object
from redner_tpu_torch.frontend.scene import Scene
from redner_tpu_torch.frontend.shape import Shape
from redner_tpu_torch.frontend.texture import Texture


def texture_from_port(tex: rtt.Texture) -> Texture:
    return Texture(tex.texels, uv_scale=tex.uv_scale)


def material_from_port(m: rtt.Material) -> Material:
    return Material(
        diffuse_reflectance=texture_from_port(m.diffuse_reflectance),
        specular_reflectance=(texture_from_port(m.specular_reflectance)
                              if m.compute_specular_lighting else None),
        roughness=texture_from_port(m.roughness),
        generic_texture=(None if m.generic_texture is None
                         else texture_from_port(m.generic_texture)),
        normal_map=(None if m.normal_map is None
                    else texture_from_port(m.normal_map)),
        two_sided=m.two_sided,
        use_vertex_color=m.use_vertex_color,
    )


def object_from_port(o: rtt.Object) -> Object:
    return Object(
        vertices=o.vertices, indices=o.indices,
        material=material_from_port(o.material), uvs=o.uvs,
        normals=o.normals, uv_indices=o.uv_indices,
        normal_indices=o.normal_indices, colors=o.colors,
        light_intensity=o.light_intensity,
        light_two_sided=o.light_two_sided,
        directly_visible=o.directly_visible, weld_ids=o.weld_ids,
    )


def camera_from_port(c: rtt.Camera) -> Camera:
    """The port's camera leaves: the intrinsic matrix (its fov is derived)
    and the look-at vectors or cam_to_world."""
    return Camera(
        position=c.position, look_at=c.look_at, up=c.up,
        cam_to_world=None if c.use_look_at else c.cam_to_world,
        intrinsic_mat=c.intrinsic_mat,
        distortion_params=c.distortion_params if c.has_distortion else None,
        clip_near=c.clip_near, resolution=c.resolution, viewport=c.viewport,
        camera_type=c.camera_type,
    )


def shape_from_port(s: rtt.Shape) -> Shape:
    shape = Shape(
        vertices=s.vertices, indices=s.indices, material_id=s.material_id,
        uvs=s.uvs, normals=s.normals, uv_indices=s.uv_indices,
        normal_indices=s.normal_indices, colors=s.colors,
        weld_ids=s.weld_ids,
    )
    shape.light_id = s.light_id
    return shape


def scene_from_port(sc: rtt.Scene) -> Scene:
    envmap = None
    if sc.envmap is not None:
        envmap = EnvironmentMap(texture_from_port(sc.envmap.values),
                                env_to_world=sc.envmap.env_to_world,
                                directly_visible=sc.envmap.directly_visible)
    return Scene(
        camera=camera_from_port(sc.camera),
        shapes=[shape_from_port(s) for s in sc.shapes],
        materials=[material_from_port(m) for m in sc.materials],
        area_lights=[AreaLight(light.shape_id, light.intensity,
                               two_sided=light.two_sided,
                               directly_visible=light.directly_visible)
                     for light in sc.area_lights],
        envmap=envmap,
    )
