"""Transform matrices of the torch front end (port of
redner_torch/transform.py; reference pyredner/transform.py),
differentiable w.r.t. tensor arguments."""

from __future__ import annotations

import torch

import redner_tpu_torch.core.transform as xf
from redner_tpu_torch.frontend._tensor import _as_tensor


def gen_look_at_matrix(pos, look, up) -> torch.Tensor:
    return xf.look_at_matrix(_as_tensor(pos), _as_tensor(look),
                             _as_tensor(up))


def gen_translate_matrix(t) -> torch.Tensor:
    return xf.gen_translate_matrix(_as_tensor(t))


def gen_scale_matrix(s) -> torch.Tensor:
    return xf.gen_scale_matrix(_as_tensor(s))


def gen_rotate_matrix(angles) -> torch.Tensor:
    return xf.gen_rotate_matrix(_as_tensor(angles))


def gen_perspective(fov_deg, clip_near, clip_far) -> torch.Tensor:
    return _as_tensor(xf.gen_perspective_matrix(
        float(fov_deg), float(clip_near), float(clip_far)))
