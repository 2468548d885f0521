"""Checkpoint and resume: state dicts of the port's scene objects (port of
redner_tpu/serialize.py; reference state_dict()/load_state_dict() on each
pyredner class, pyredner/scene.py:70-86).

A state dict maps a path of field names and indices ("shapes/0/vertices")
to each tensor of a Scene (or any of its dataclasses) as a numpy array.
Beside the tensors it carries a structure token: the dataclass types, the
field names, tuple lengths, which optional fields are None and every
non-tensor field (camera type, resolution, material ids, flags...).
load_state_dict refuses a state whose token differs or that lacks a path,
as the JAX package does with its treedef.  Files do not load across the two
packages: JAX's token is a jax treedef string.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch


def _walk(obj, path, leaves, fill=None):
    """(structure token, rebuilt object): every tensor is recorded under
    its path in `leaves`, or replaced from `fill` when it is given."""
    if torch.is_tensor(obj):
        key = "/".join(path)
        if fill is None:
            leaves[key] = obj
            return "T", obj
        if key not in fill:
            raise KeyError(f"state_dict missing leaf {key!r}")
        return "T", torch.as_tensor(np.asarray(fill[key]), dtype=obj.dtype,
                                    device=obj.device)
    if isinstance(obj, (tuple, list)):
        parts = [_walk(o, path + (str(i),), leaves, fill)
                 for i, o in enumerate(obj)]
        return (f"{type(obj).__name__}[{','.join(p[0] for p in parts)}]",
                type(obj)(p[1] for p in parts))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        tokens, fields = [], {}
        for f in dataclasses.fields(obj):
            tok, fields[f.name] = _walk(getattr(obj, f.name),
                                        path + (f.name,), leaves, fill)
            tokens.append(f"{f.name}={tok}")
        return (f"{type(obj).__name__}({','.join(tokens)})",
                dataclasses.replace(obj, **fields))
    return repr(obj), obj


def named_tensors(obj) -> Dict[str, torch.Tensor]:
    """{path: tensor} of every tensor of a Scene (or dataclass), under the
    paths state_dict uses ("materials/0/diffuse_reflectance/texels")."""
    leaves: Dict[str, torch.Tensor] = {}
    _walk(obj, (), leaves)
    return leaves


def state_dict(obj) -> Dict[str, Any]:
    """Scene (or dataclass) -> {path: numpy array} plus the structure token
    under '__structure__'."""
    leaves: Dict[str, torch.Tensor] = {}
    token, _ = _walk(obj, (), leaves)
    out: Dict[str, Any] = {k: v.detach().cpu().numpy()
                           for k, v in leaves.items()}
    out["__structure__"] = token
    return out


def load_state_dict(obj, state: Dict[str, Any]):
    """`obj` with every tensor replaced from `state` (same dtype and
    device as obj's); the structure must match obj's exactly."""
    expected, _ = _walk(obj, (), {})
    saved = state.get("__structure__")
    if saved is not None and saved != expected:
        raise ValueError("state_dict structure mismatch:\n"
                         f"  saved:    {saved}\n  expected: {expected}")
    return _walk(obj, (), {}, fill=state)[1]


def save_scene(scene, filename: str):
    """Persist a scene's state dict to .npz."""
    sd = state_dict(scene)
    token = sd.pop("__structure__")
    np.savez(filename, __structure__=np.asarray(token), **sd)


def load_scene(scene_template, filename: str):
    """Load a .npz written by save_scene into a scene of the same
    structure."""
    data = np.load(filename, allow_pickle=False)
    sd = {k: data[k] for k in data.files if k != "__structure__"}
    sd["__structure__"] = str(data["__structure__"])
    return load_state_dict(scene_template, sd)
