"""The port's scrambled Sobol sampler against redner_tpu.sampler on the
CPU: the shipped direction-number table and the generator that made it,
and the uniforms bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu.sampler as jsamp
import redner_tpu_torch.sampler as tsamp
from redner_tpu_torch import sobol_table
from tests.torch_port_util import two_torch_threads  # noqa: F401

SEEDS = (0, 7, 2**32 - 1)
DIMS = (0, 1, 20, 21, 1023, 1024)


def _ids(n=512, seed=0):
    """Pixel and sample ids as uint32, the extremes and ids above 2^31
    included."""
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    sid = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    pix[:4] = [0, 1, 2**31, 2**32 - 1]
    sid[:4] = [2**32 - 1, 2**31 + 5, 0, 3]
    return pix, sid


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def test_table_equals_reference():
    """The shipped table (version 3) is the JAX package's, bit for bit."""
    V = sobol_table.load_sobol_table()
    assert V.dtype == np.uint32
    assert V.shape == (sobol_table.SOBOL_TABLE_DIMS, 32)
    np.testing.assert_array_equal(V, np.asarray(jsamp._SOBOL_V))


def test_generator_rebuilds_first_dims():
    """The port's copy of the screened generator rebuilds the first 40
    dims of the table: the 20 Joe-Kuo dims and 19 drawn and screened
    ones."""
    V = sobol_table.build_sobol_table(40)
    np.testing.assert_array_equal(V, sobol_table.load_sobol_table()[:40])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dim", DIMS)
def test_sobol_uniform_bit_exact(seed, dim):
    pix, sid = _ids()
    ref = np.asarray(jsamp.sobol_uniform(jnp.uint32(seed), jnp.asarray(pix),
                                         jnp.asarray(sid), dim))
    got = tsamp.sobol_uniform(seed, _t(pix), _t(sid), dim)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_sobol_uniforms_bit_exact_across_table_end(seed):
    """Seven dims straddling the table's end: four from the table, three
    from the hash fallback."""
    pix, sid = _ids(seed=1)
    ref = np.asarray(jsamp.sobol_uniforms(jnp.uint32(seed), jnp.asarray(pix),
                                          jnp.asarray(sid), 1020, 7))
    got = tsamp.sobol_uniforms(seed, _t(pix), _t(sid), 1020, 7)
    assert got.shape == (512, 7)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("case", ["camera", "bounce", "edge", "secondary"])
def test_draw_matches_on_lane_arrays(case):
    """draw() as the render calls it: per-lane pixel and sample ids (the
    image loop), one pixel with N sample ids (the primary-edge draw), and
    the secondary-edge dims."""
    pix, sid = _ids(n=1000, seed=2)
    seed = 2**32 - 1
    if case == "camera":
        args = (jnp.asarray(pix), jnp.asarray(sid), 0, 2)
        targs = (_t(pix), _t(sid), 0, 2)
    elif case == "bounce":
        args = (jnp.asarray(pix), jnp.asarray(sid), 9, 4)
        targs = (_t(pix), _t(sid), 9, 4)
    elif case == "edge":
        seed = (seed + jsamp.EDGE_SEED_OFFSET) & 0xFFFFFFFF
        args = (jnp.zeros((), jnp.int32), jnp.arange(1000), 0, 2)
        targs = (0, torch.arange(1000), 0, 2)
    else:
        args = (jnp.asarray(pix), jnp.uint32(3), 105, 3)
        targs = (_t(pix), 3, 105, 3)
    ref = np.asarray(jsamp.draw(jsamp.SamplerType.sobol, jnp.uint32(seed),
                                *args))
    got = tsamp.draw(tsamp.SamplerType.sobol, seed, *targs)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ((got >= 0) & (got < 1)).all()
