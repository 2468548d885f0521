"""Shape of the torch front end and the mesh utilities (port of
redner_torch/shape.py; reference pyredner/shape.py)."""

from __future__ import annotations

import torch

import redner_tpu_torch as rtt
from redner_tpu_torch import meshops
from redner_tpu_torch.frontend._tensor import _as_int_tensor, _as_tensor


class Shape:
    """Triangle mesh with optional uvs, normals and colours; vertices, uvs,
    normals and colours are differentiable leaves.  weld_ids, the (V,)
    load-time weld map of a loaded mesh, keys edge extraction."""

    def __init__(
        self,
        vertices,
        indices,
        material_id: int = 0,
        uvs=None,
        normals=None,
        uv_indices=None,
        normal_indices=None,
        colors=None,
        weld_ids=None,
    ):
        self.vertices = _as_tensor(vertices)
        self.indices = _as_int_tensor(indices)
        self.material_id = int(material_id)
        self.uvs = _as_tensor(uvs)
        self.normals = _as_tensor(normals)
        self.uv_indices = _as_int_tensor(uv_indices)
        self.normal_indices = _as_int_tensor(normal_indices)
        self.colors = _as_tensor(colors)
        self.weld_ids = _as_int_tensor(weld_ids)
        self.light_id = -1

    def _build(self, dev, light_id: int) -> rtt.Shape:
        return rtt.make_shape(
            vertices=self.vertices, indices=self.indices, uvs=self.uvs,
            normals=self.normals, uv_indices=self.uv_indices,
            normal_indices=self.normal_indices, colors=self.colors,
            material_id=self.material_id, light_id=light_id,
            weld_ids=self.weld_ids, device=dev,
        )


def compute_vertex_normal(vertices, indices,
                          weighting_scheme="max") -> torch.Tensor:
    """Vertex normals, differentiable w.r.t. the vertices
    (reference pyredner/shape.py compute_vertex_normal)."""
    return rtt.compute_vertex_normal(_as_tensor(vertices),
                                     _as_tensor(indices, torch.int64),
                                     weighting_scheme=weighting_scheme)


def compute_uvs(vertices, indices, print_progress=False):
    """UV atlas from the native charting helper -> (uvs, uv_indices) on the
    default device (reference pyredner/shape.py:279-326)."""
    uvs, uv_indices = meshops.compute_uvs(
        _as_tensor(vertices).detach().cpu().numpy(),
        _as_int_tensor(indices).cpu().numpy())
    return _as_tensor(uvs), _as_int_tensor(uv_indices)


def smooth(vertices, indices, lmbda=0.5) -> torch.Tensor:
    """One uniform Laplacian smoothing step, differentiable
    (reference pyredner/shape.py:160-276)."""
    return rtt.smooth(_as_tensor(vertices), _as_tensor(indices, torch.int64),
                      lmbda)
