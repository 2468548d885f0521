"""redner_tpu_torch.ops.gather_cuda on the CPU: gather_rows and
scatter_rows run their plain versions there, which must be what autograd
computes for `table[clamp(idx)]`, bit for bit, forward, backward and
second order; the Functions' wiring (each the other's backward, the
forward-mode tangent) is checked by gradcheck and gradgradcheck in
float64.  The kernels themselves are held against the plain versions on
the card (tests/test_torch_port_cuda.py)."""

import pytest
import torch
import torch.autograd.forward_ad as fwAD

from redner_tpu_torch.ops import gather_cuda as gc
from torch_port_util import one_thread, two_torch_threads  # noqa: F401

# (rows, cols, ids): every id equal on a one-row table, a 3-row table, ids
# out of range (clamped), no lanes at all, ids of rank 2.
CASES = {
    "one_row_all_equal": (1, 3, [0] * 40),
    "three_rows": (3, 12, [2, 0, 1, 1, 2, 2, 0, 1, 2, 0, 0, 1, 2]),
    "out_of_range": (4, 5, [-3, 7, 0, 3, 4, -1, 2, 100, 1]),
    "empty": (5, 4, []),
    "rank2": (6, 34, [[0, 5, 5, 1], [3, 3, 2, 9], [-2, 4, 4, 4]]),
}


def _case(name, dtype=torch.float64, seed=0):
    rows, cols, ids = CASES[name]
    g = torch.Generator().manual_seed(seed)
    table = torch.randn((rows, cols), generator=g, dtype=dtype)
    idx = torch.as_tensor(ids, dtype=torch.int64)
    return table, idx


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_path_is_table_indexing(name, dtype, one_thread):  # noqa: F811
    """Forward, backward and the backward's backward (of a loss quadratic
    in the rows) equal autograd's own through table[clamp(idx, 0, R - 1)]
    bit for bit."""
    table, idx = _case(name, dtype)
    rows = table.shape[0]
    w = torch.randn(tuple(idx.shape) + (table.shape[1],), dtype=dtype,
                    generator=torch.Generator().manual_seed(1))
    results = []
    for fn in (gc.gather_rows,
               lambda t, i: t[torch.clamp(i, 0, rows - 1)]):
        t = table.clone().requires_grad_(True)
        out = fn(t, idx)
        (g,) = torch.autograd.grad((out * out * w).sum(), t,
                                   create_graph=True)
        h = (torch.autograd.grad((g * g).sum(), t)[0] if g.requires_grad
             else None)
        results.append((out.detach(), g.detach(), h))
    (out, g, h), (out_ref, g_ref, h_ref) = results
    assert out.shape == tuple(idx.shape) + (table.shape[1],)
    assert torch.equal(out, out_ref) and torch.equal(g, g_ref)
    assert (h is None) == (h_ref is None)
    assert h is None or torch.equal(h, h_ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_scatter_plain_sums_rows_by_clamped_id(name):
    """scatter_rows is the per-row sum of its lanes, ids clamped, a loop
    over lanes as reference."""
    table, idx = _case(name)
    rows, cols = table.shape
    src = torch.randn(tuple(idx.shape) + (cols,), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(2))
    got = gc.scatter_rows(src, idx, rows)
    want = torch.zeros((rows, cols), dtype=torch.float64)
    for i, r in zip(idx.reshape(-1).tolist(), src.reshape(-1, cols)):
        want[min(max(i, 0), rows - 1)] += r
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradcheck_and_gradgradcheck(name):
    """gather_rows's backward is scatter_rows and scatter_rows's is
    gather_rows: first and second derivatives against finite
    differences, in float64."""
    table, idx = _case(name)
    rows = table.shape[0]
    t = table.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda x: gc.gather_rows(x, idx), (t,))
    assert torch.autograd.gradgradcheck(lambda x: gc.gather_rows(x, idx),
                                        (t,))
    src = torch.randn(tuple(idx.shape) + (table.shape[1],),
                      dtype=torch.float64, requires_grad=True,
                      generator=torch.Generator().manual_seed(3))
    assert torch.autograd.gradcheck(
        lambda s: gc.scatter_rows(s, idx, rows), (src,))
    assert torch.autograd.gradgradcheck(
        lambda s: gc.scatter_rows(s, idx, rows), (src,))


def test_forward_mode_tangents():
    """The forward-mode tangent of a gather is the gather of the tangent,
    and a scatter's the scatter of the tangent (screen_gradient runs the
    renderer under forward AD)."""
    table, idx = _case("rank2")
    rows = table.shape[0]
    tan = torch.randn_like(table)
    with fwAD.dual_level():
        out = gc.gather_rows(fwAD.make_dual(table, tan), idx)
        p, t = fwAD.unpack_dual(out)
    assert torch.equal(p, gc.gather_plain(table, idx))
    assert torch.equal(t, gc.gather_plain(tan, idx))
    src = torch.randn(tuple(idx.shape) + (table.shape[1],),
                      dtype=torch.float64)
    stan = torch.randn_like(src)
    with fwAD.dual_level():
        out = gc.scatter_rows(fwAD.make_dual(src, stan), idx, rows)
        p, t = fwAD.unpack_dual(out)
    assert torch.equal(p, gc.scatter_plain(src, idx, rows))
    assert torch.equal(t, gc.scatter_plain(stan, idx, rows))


def test_no_backward_without_a_table_gradient():
    """A table that needs no gradient gives an output that needs none, so
    no scatter runs (screen_gradient's tables)."""
    table, idx = _case("three_rows")
    out = gc.gather_rows(table, idx)
    assert not out.requires_grad and out.grad_fn is None


def test_variant_follows_the_table_size():
    """The cell's light and material tables take the block variant, the
    face table (15,752 x 34 float32) the warp variant."""
    for rows, cols in ((1, 3), (3, 3), (3, 1), (3, 12), (32, 32)):
        assert gc.scatter_variant(rows, cols, 4) == "block"
    assert gc.scatter_variant(32, 32, 8) == "warp"
    assert gc.scatter_variant(15752, 34, 4) == "warp"


@pytest.mark.parametrize("n", [1, 31, 33, 256, 5000, 65536, 262144])
@pytest.mark.parametrize("size_bytes", [12, 144, 4096])
def test_block_grid_covers_the_lanes(n, size_bytes):
    """The block variant's grid: whole warps a block, every lane in one
    block and none left over, at most one block an SM, partials within
    PARTIAL_BYTES."""
    blocks, per_block = gc.block_grid(n, size_bytes, 132)
    assert per_block % 32 == 0 and blocks >= 1
    assert (blocks - 1) * per_block < n <= blocks * per_block
    assert blocks <= 132
    assert blocks * size_bytes <= max(gc.PARTIAL_BYTES, size_bytes)


@pytest.mark.parametrize("n", [1, 32, 33, 64, 1000, 65536, 262144, 10**7])
def test_warp_levels_fit_their_buffers(n):
    """The warp variant's levels: each sequence 16 times shorter than the
    one before (two entries a tile of 32) until one tile is left; the k-th
    sequence (k >= 1; level k - 1 writes it) goes to buffer a
    (next_level(n) entries) when k is odd and b (next_level of that) when
    even, so each fits the buffer it is written to."""
    a = gc.next_level(n)
    b = gc.next_level(a)
    m, k = a, 1
    while m:
        assert m <= (a if k % 2 else b)
        nxt = gc.next_level(m)
        assert nxt == 0 or nxt <= max(2, m // 8)
        m, k = nxt, k + 1
    assert k <= 7
