"""redner_tpu_torch's scene checkpoints (tests/test_serialize.py's patterns
on the port, CPU): state_dict/load_state_dict and save_scene/load_scene
round trips, paths made of field names and indices, and the structure
check.  The JAX package's own state dict of the same scene holds the same
arrays (its paths differ: a jax treedef is not portable)."""

import dataclasses

import numpy as np
import pytest
import torch

import redner_tpu as rt
import redner_tpu_torch as rtt
from redner_tpu_torch.scene import scene_leaves
from tests.scene_util import envmap_scene, single_triangle_scene
from tests.torch_port_util import port_scene, two_torch_threads  # noqa: F401


def _moved(scene):
    s0 = scene.shapes[0]
    return dataclasses.replace(scene, shapes=(dataclasses.replace(
        s0, vertices=s0.vertices + 1.0),) + scene.shapes[1:])


@pytest.mark.parametrize("make", [single_triangle_scene, envmap_scene],
                         ids=["triangle", "envmap"])
def test_state_dict_round_trip(make):
    jscene = make()
    scene = port_scene(jscene)
    sd = rtt.state_dict(scene)
    assert "shapes/0/vertices" in sd and "camera/intrinsic_mat" in sd
    restored = rtt.load_state_dict(_moved(scene), sd)
    for a, b in zip(scene_leaves(restored), scene_leaves(scene)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # The same arrays as in redner_tpu's state dict of the same scene.
    jvals = [np.asarray(v) for k, v in rt.state_dict(jscene).items()
             if k != "__treedef__"]
    for k in ("shapes/0/vertices", "camera/intrinsic_mat"):
        assert any(v.shape == sd[k].shape and np.array_equal(v, sd[k])
                   for v in jvals), k


def test_save_load_npz(tmp_path):
    scene = port_scene(single_triangle_scene())
    path = str(tmp_path / "ckpt.npz")
    rtt.save_scene(scene, path)
    loaded = rtt.load_scene(_moved(scene), path)
    opts = rtt.RenderOptions(num_samples=1, max_bounces=0,
                             channels=(rtt.Channels.alpha,))
    a = rtt.render_image(scene, opts, seed=0)
    b = rtt.render_image(loaded, opts, seed=0)
    assert torch.equal(a, b)


def test_structure_mismatch_raises():
    scene = port_scene(single_triangle_scene())
    sd = rtt.state_dict(scene)
    with pytest.raises(ValueError, match="structure mismatch"):
        rtt.load_state_dict(dataclasses.replace(
            scene, shapes=scene.shapes[:1]), sd)
    other_cam = dataclasses.replace(scene.camera, resolution=(3, 3))
    with pytest.raises(ValueError, match="structure mismatch"):
        rtt.load_state_dict(dataclasses.replace(scene, camera=other_cam), sd)
    del sd["shapes/0/vertices"]
    with pytest.raises(KeyError, match="shapes/0/vertices"):
        rtt.load_state_dict(scene, sd)
