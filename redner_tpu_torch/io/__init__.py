"""Scene and image IO (port of redner_tpu.io; reference pyredner loaders):
OBJ/MTL, Mitsuba XML and serialized meshes, EXR through the package's own
codec, LDR and .hdr images through PIL and OpenCV when those are asked for."""

from redner_tpu_torch.io.image import (imread, imwrite, linear_to_srgb,
                                       srgb_to_linear)
from redner_tpu_torch.io.mitsuba import load_mitsuba
from redner_tpu_torch.io.obj import load_obj, save_mtl, save_obj
from redner_tpu_torch.io.serialized import load_serialized

__all__ = [
    "imread", "imwrite", "linear_to_srgb", "srgb_to_linear", "load_obj",
    "save_obj", "save_mtl", "load_serialized", "load_mitsuba",
]
