"""What the ray-query kernels are fed and what they merge, on the CPU.

The CUDA kernels of redner_tpu_torch/csrc/intersect.cu run only on the card
(tests/test_torch_port_cuda.py), so everything around them that is plain
PyTorch is held here: the per-triangle packing of the coefficients, the
closest-hit merge key, and the rank-major work list of active (tile, chunk)
pairs.  An emulation of the kernels' item-by-item closest-hit merge, in a
shuffled item order, must give closest_plain's answer exactly, ties
included.  The sphere is the scene of test_torch_port_intersect.py: 4,832
triangles in 10 chunks, so the Morton ray sort and the culling engage."""

import numpy as np
import pytest
import torch

from redner_tpu_torch.core.types import Ray
from redner_tpu_torch.ops import intersect as plain
from redner_tpu_torch.ops import intersect_cuda as ic
from redner_tpu_torch.scene import flatten_scene
from tests.test_torch_port_cuda import (grid_plane, tie_rays, tie_scene,
                                        unbalanced_rays)
from tests.test_torch_port_intersect import _sphere_scene
from tests.torch_port_util import port_scene, two_torch_threads  # noqa: F401

QUART = 128  # triangles per kernel work item (csrc/intersect.cu QUART)


@pytest.fixture(scope="module")
def sphere():
    fs = flatten_scene(port_scene(_sphere_scene()))
    assert fs.num_triangles == 4832 and fs.layout.nchunks == 10
    return fs


def _rays(n, seed, toward_sphere):
    rng = np.random.default_rng(seed)
    org = rng.normal(0, 3, (n, 3)).astype(np.float32)
    if toward_sphere:
        d = rng.normal(0, 0.3, (n, 3)) - org
    else:
        d = rng.normal(0, 1, (n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[:3] = 0.0  # dead lanes
    tmax = np.where(rng.uniform(size=n) < 0.5, np.inf,
                    rng.uniform(0.5, 8.0, n)).astype(np.float32)
    t = torch.as_tensor
    return Ray(org=t(org), dir=t(d), tmin=t(np.full(n, 1e-3, np.float32)),
               tmax=t(tmax))


# ---------------------------------------------------------------- packing


def test_packed_layout_gathers_the_nonzero_coefficients(sphere):
    """Tp row j of chunk c holds Tc[c, k, g*CHUNK + j] for the 19 (k, g) in
    the kernels' order (det k 0-2, u k 0-5, v k 0-5, t k 6-9), then a zero;
    the other 21 coefficients are zero for every triangle."""
    lay = sphere.layout
    C = plain.CHUNK
    Tc = lay.Tc.numpy().reshape(lay.nchunks, 10, 4, C)
    order = ([(k, 0) for k in range(3)] + [(k, 1) for k in range(6)]
             + [(k, 2) for k in range(6)] + [(k, 3) for k in range(6, 10)])
    want = np.zeros((lay.nchunks * C, 20), np.float32)
    for r, (k, g) in enumerate(order):
        want[:, r] = Tc[:, k, g, :].reshape(-1)
    assert lay.Tp.dtype == torch.float32 and lay.Tp.is_contiguous()
    np.testing.assert_array_equal(lay.Tp.numpy(), want)
    rest = np.ones((10, 4), bool)
    for k, g in order:
        rest[k, g] = False
    assert not Tc[:, rest, :].any()
    assert lay.ntri == sphere.num_triangles


# ------------------------------------------------------------------- keys


def test_key_order_is_t_then_lower_index():
    rng = np.random.default_rng(3)
    t = np.concatenate([rng.normal(0, 10, 500), rng.normal(0, 1e-30, 50),
                        [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45,
                         np.finfo(np.float32).max]]).astype(np.float32)
    t = np.concatenate([t, t[:200]])  # exact ties
    idx = rng.integers(0, 2**31 - 1, t.shape[0])
    keys = ic.pack_hit_key(torch.as_tensor(t), torch.as_tensor(idx)).numpy()
    by_key = np.argsort(keys, kind="stable")
    by_t_idx = np.lexsort((idx, t + np.float32(0.0)))  # -0 sorts as +0
    np.testing.assert_array_equal(keys[by_key], keys[by_t_idx])
    assert (keys < ic.NO_HIT).all()


def test_key_ties_resolve_to_the_lower_index():
    t = torch.tensor([2.5, 2.5, 0.0, -0.0, np.inf, np.inf])
    idx = torch.tensor([7, 3, 9, 4, 100, 2])
    k = ic.pack_hit_key(t, idx)
    assert k[1] < k[0] and k[3] < k[2] and k[5] < k[4]
    assert k[4] < ic.NO_HIT


@pytest.mark.parametrize("t", [-3.25, -1e-45, -0.0, 0.0, 1e-45, 1.5,
                               3.4e38, np.inf])
def test_key_round_trip(t):
    idx = torch.tensor([0, 1, 123_456, 2**31 - 1])
    tt = torch.full((4,), t, dtype=torch.float32)
    back_t, back_i = ic.unpack_hit_key(ic.pack_hit_key(tt, idx))
    assert back_t.dtype == torch.float32 and back_i.dtype == torch.int32
    want = tt + 0.0  # -0 comes back as +0
    assert torch.equal(back_t.view(torch.int32), want.view(torch.int32))
    assert torch.equal(back_i, idx.to(torch.int32))


def test_no_hit_key_unpacks_to_a_miss():
    key = torch.tensor([ic.NO_HIT, ic.NO_HIT], dtype=torch.int64)
    t, i = ic.unpack_hit_key(key)
    assert torch.isinf(t).all() and (t > 0).all() and (i == -1).all()


# -------------------------------------------------------------- work list


def _check_work_list(mask, pairs, count):
    """pairs holds the capacity of rows (one per (tile, chunk)), every row
    in range; its first count rows are exactly the active pairs, in
    order."""
    mask = np.asarray(mask, bool)
    pairs = np.asarray(pairs, np.int64)
    count = np.asarray(count)
    assert count.shape == (1,) and int(count[0]) == int(mask.sum())
    assert pairs.shape == (mask.size, 2)
    assert ((pairs >= 0) & (pairs < mask.shape)).all()
    pairs = pairs[:int(count[0])]
    got = np.zeros_like(mask)
    got[pairs[:, 0], pairs[:, 1]] = True
    np.testing.assert_array_equal(got, mask)  # exactly the active pairs
    rank = (np.cumsum(mask, axis=1) - 1)[pairs[:, 0], pairs[:, 1]]
    key = rank * mask.shape[0] + pairs[:, 0]
    assert (np.diff(key) > 0).all()  # rank-major, tiles ascending per rank
    for tile in np.unique(pairs[:, 0]):  # each tile's chunks ascending
        assert (np.diff(pairs[pairs[:, 0] == tile, 1]) > 0).all()


@pytest.mark.parametrize("density", [0.0, 0.05, 0.3, 1.0])
def test_work_list_random_masks(density):
    rng = np.random.default_rng(int(density * 100))
    mask = rng.uniform(size=(37, 23)) < density
    mask[5] = True  # one tile with every chunk
    if density == 0.0:
        mask[:] = False
    pairs, count = ic._active_lists(torch.as_tensor(mask))
    assert pairs.dtype == torch.int32 and pairs.is_contiguous()
    assert count.dtype == torch.int32
    _check_work_list(mask, pairs.numpy(), count.numpy())


@pytest.mark.parametrize("toward", [False, True])
def test_work_list_of_a_ray_batch(sphere, toward):
    rb = ic.prepare_rays(sphere, _rays(1500, seed=4, toward_sphere=toward))
    assert int(rb.count) > 0
    _check_work_list(rb.mask.numpy(), rb.pairs.numpy(), rb.count.numpy())
    assert torch.equal(rb.tile_active, rb.mask.any(dim=1))


@pytest.mark.parametrize("tiles", [1, 2])
def test_mask_in_blocks_equals_one_block(monkeypatch, tiles):
    """The activity mask's slab tests over blocks of `tiles` tiles
    (ic.MASK_BLOCK) give the mask of one block over the whole batch, and
    so the same work list: the card tests' unbalanced batch on the grid
    plane, whose tiles have different chunks active."""
    fs = grid_plane("cpu")
    ray = unbalanced_rays("cpu")
    one = ic.prepare_rays(fs, ray, presorted=True)
    monkeypatch.setattr(ic, "MASK_BLOCK",
                        tiles * plain.TILE_N * fs.layout.nchunks)
    blocks = ic.prepare_rays(fs, ray, presorted=True)
    assert one.mask.shape[0] > 2 * tiles
    assert bool(one.mask.any()) and not bool(one.mask.all())
    assert torch.equal(blocks.mask, one.mask)
    assert torch.equal(blocks.pairs, one.pairs)
    assert torch.equal(blocks.count, one.count)


def test_unbalanced_and_tie_batches():
    """The card tests' batches have the work lists they claim, and the
    plain versions give the tie to the lower sorted index."""
    fs = grid_plane("cpu")
    assert fs.layout.nchunks == 16
    rb = ic.prepare_rays(fs, unbalanced_rays("cpu"), presorted=True)
    active = rb.mask.sum(dim=1)
    assert int(active[0]) == 16 and int(active[1]) == 0
    assert (active[2:] == 1).all()
    best_t, best_i = plain.closest_plain(fs.layout.Tc, rb)
    blocked, _ = plain.anyhit_plain(fs.layout.Tc, rb)
    assert 0 < int((best_i >= 0).sum()) < rb.n
    assert torch.equal(blocked, best_i >= 0)

    fs = tie_scene("cpu")
    assert fs.layout.nchunks == 2 and fs.layout.ntri == 602
    assert torch.equal(fs.layout.idx_map[:602], torch.arange(602))
    rb = ic.prepare_rays(fs, tie_rays("cpu"), presorted=True)
    assert rb.mask.all()
    best_t, best_i = plain.closest_plain(fs.layout.Tc, rb)
    assert (best_i[: rb.n] == 0).all() and (best_t[: rb.n] == 2.0).all()


# ------------------------------------------------ the merge, emulated


def _t_blocks(lay, rb):
    """Every (tile, chunk) pair's (TILE_N, CHUNK) block of hit distances, as
    one (nchunks, ntile, TILE_N, CHUNK) tensor: one pass over the chunks
    with the products closest_plain takes."""
    ntile = rb.R.shape[0] // plain.TILE_N
    return torch.stack([
        plain._exact_hit(rb.R @ lay.Tc[c], rb.tmin, rb.tmax)[1].reshape(
            ntile, plain.TILE_N, plain.CHUNK)
        for c in range(lay.nchunks)])


def _closest_by_items(lay, rb, seed, blocks=None):
    """The closest-hit kernel's algorithm in plain PyTorch: every item (an
    active pair's 128-triangle quarter, padding left out) takes the first
    minimum t of its real triangles per lane, packs it into a key and
    merges it by minimum, in a shuffled item order.  blocks: _t_blocks of
    the batch, when the caller already has them."""
    if blocks is None:
        blocks = _t_blocks(lay, rb)
    keys = torch.full((rb.R.shape[0],), ic.NO_HIT, dtype=torch.int64)
    items = [(p, q) for p in range(int(rb.count))
             for q in range(plain.CHUNK // QUART)]
    np.random.default_rng(seed).shuffle(items)
    for p, q in items:
        tile, c = (int(x) for x in rb.pairs[p])
        lo = q * QUART
        cnt = min(QUART, lay.ntri - c * plain.CHUNK - lo)
        if cnt <= 0:
            continue
        lanes = slice(tile * plain.TILE_N, (tile + 1) * plain.TILE_N)
        t = blocks[c, tile, :, lo:lo + cnt]
        arg = torch.argmin(t, dim=1)
        t_best = torch.gather(t, 1, arg[:, None])[:, 0]
        k = ic.pack_hit_key(t_best, c * plain.CHUNK + lo + arg)
        keys[lanes] = torch.where(torch.isfinite(t_best),
                                  torch.minimum(keys[lanes], k), keys[lanes])
    return ic.unpack_hit_key(keys)


@pytest.mark.parametrize("toward", [False, True])
def test_item_merge_equals_closest_plain(sphere, toward):
    lay = sphere.layout
    rb = ic.prepare_rays(sphere, _rays(1000, seed=5, toward_sphere=toward))
    pt, pi = plain.closest_plain(lay.Tc, rb)
    assert int((pi >= 0).sum()) > 100
    blocks = _t_blocks(lay, rb)
    for seed in (0, 1):
        t, i = _closest_by_items(lay, rb, seed, blocks)
        assert torch.equal(i.to(torch.int64), pi)
        assert torch.equal(t, pt)


def test_item_merge_keeps_ties():
    fs = tie_scene("cpu")
    rb = ic.prepare_rays(fs, tie_rays("cpu"), presorted=True)
    pt, pi = plain.closest_plain(fs.layout.Tc, rb)
    t, i = _closest_by_items(fs.layout, rb, seed=2)
    assert torch.equal(i.to(torch.int64), pi) and torch.equal(t, pt)
    assert (i[: rb.n] == 0).all()
