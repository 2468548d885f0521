"""The port's edge-sampled gradient on two gloo ranks against jax.grad of
redner_tpu.render with the pixels sharded over the 8 virtual CPU devices
(tests/conftest.py), on the single triangle scene at 16x16, 2 spp."""

import jax
import jax.numpy as jnp
import numpy as np

import redner_tpu as rt
from redner_tpu.parallel.sharding import make_mesh, pixel_sharding
from tests.scene_util import single_triangle_scene
from redner_tpu_torch.parallel.spawn import run_ranks
from tests.torch_port_spawn import RENDER_OPTIONS, sharded_results
from tests.torch_port_util import two_torch_threads  # noqa: F401


def test_world2_edge_gradient_matches_jax_sharded(tmp_path):
    scene = single_triangle_scene(res=(16, 16))
    opts = rt.RenderOptions(**RENDER_OPTIONS)
    sh = pixel_sharding(make_mesh())

    def loss(v):
        s = scene.replace(
            shapes=(scene.shapes[0].replace(vertices=v),) + scene.shapes[1:])
        return jnp.sum(rt.render(s, opts, seed=1, pixel_sharding=sh))

    ref = np.asarray(jax.grad(loss)(scene.shapes[0].vertices))
    assert np.abs(ref).max() > 0
    ranks = run_ranks(2, sharded_results, ((16, 16), False), tmp_path)
    for r in ranks:
        np.testing.assert_allclose(r["edge_grads"]["vertices"].numpy(), ref,
                                   rtol=1e-3, atol=1e-5 * np.abs(ref).max())
