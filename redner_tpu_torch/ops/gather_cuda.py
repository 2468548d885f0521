"""Per-lane row gathers from float tables and their scatter-add backward
on Hopper: `gather_rows(table, idx)` is `table[clamp(idx, 0, R - 1)]`
with a backward that reduces duplicate rows where the lanes meet them.

The renderer fetches a row of a small float table for every lane of a
pass: the hit triangle's face row (34 floats), the material's rows, the
light's intensity.  PyTorch's backward of `table[idx]` on the card sorts
the ids and adds each run of equal ids serially, one warp a distinct row;
a scene with one light or a floor of two triangles makes those runs tens
of thousands of lanes long.  The kernels in csrc/gather.cu (compiled for
sm_90a by nvcc into a shared library with a C interface at first use,
called through ctypes) replace it; they replace no TPU kernel (the JAX
package leaves these gathers to XLA, and turns small-table ones into
one-hot products for the TPU's matrix unit).

`gather_rows` and `scatter_rows` are autograd Functions, each the other's
backward, so second derivatives (create_graph) and forward-mode tangents
go through them.  On CPU tensors they run the plain versions, which are
what autograd computes for `table[idx]` today: `table[idx]` and
`zeros.index_put_(idx, src, accumulate=True)`.  On CUDA tensors they
launch the kernels (a failed build or launch raises):

  * gather_rows: one launch, ids clamped inside;
  * scatter_rows, chosen by the table's size: a table of at most
    BLOCK_TABLE_BYTES takes the block variant (copies of the table in
    shared memory, per-block partials summed in block order by a second
    pass); a larger one the warp variant (the ids stably sorted, equal ids
    of 32 consecutive sorted lanes merged by shuffles, runs that cross
    tiles finished by levels of the same kernel on a sequence 16 times
    shorter each).  Neither adds floats with atomics: both give the same
    bits at every run and in every CUDA graph.

Each wrapper counts its launches in LAUNCHES ("gather_rows",
"scatter_rows.block", "scatter_rows.warp").  With tracing on
(timing.set_tracing) a scatter also adds, on the device, the lane-columns
it scattered and the values it wrote (table rows and partials) to WORK,
which a CUDA graph's replays keep adding to: their ratio is the merge
factor.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from redner_tpu_torch import timing
from redner_tpu_torch.ops.nvcc import CSRC, build_library

# Tables up to this many bytes take the block variant: 8 warps' copies in
# a block's shared memory (32 KB).
BLOCK_TABLE_BYTES = 4096
# The block variant's partials (blocks x table) stay within this many bytes.
PARTIAL_BYTES = 16384
BLOCK = 256  # threads a block, as in csrc/gather.cu

# Launches since the last reset_launch_counts(); the plain path on CPU
# tensors does not count.
LAUNCHES = {"gather_rows": 0, "scatter_rows.block": 0,
            "scatter_rows.warp": 0}

# {device: int64 (2,) tensor}: the lane-columns scattered and the updates
# (values written: table rows and partials) of the scatters launched with
# tracing on, added on the device (made outside any capture, so graphs add
# into it).
WORK = {}

_SRC = CSRC / "gather.cu"
_DTYPES = {torch.float32: 0, torch.float64: 1}
_ITYPES = {torch.int32: 0, torch.int64: 1}
_lib_handle = None


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def work_counts():
    """(lane-columns, updates) of the traced scatters so far, summed over
    devices (reads the device sums, so it waits for the card)."""
    tot = [0, 0]
    for acc in WORK.values():
        a = acc.tolist()
        tot = [tot[0] + a[0], tot[1] + a[1]]
    return tuple(tot)


def reset_work_counts():
    """Zeros WORK in place (the graphs keep adding into the same sums)."""
    for acc in WORK.values():
        acc.zero_()


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile csrc/gather.cu for sm_90a into nvcc.BUILD_DIR (once per
    source version).  Returns (library path, compiler output); verbose
    adds `-Xptxas -v` and forces a rebuild."""
    return build_library(_SRC, "gather", verbose)


def _lib():
    global _lib_handle
    if _lib_handle is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # (table, ids, dtype, idtype, n, rows, cols, out, stream)
        lib.rt_gather_rows.argtypes = [p, p, i, i, q, i, i, p, p]
        # (src, sorted ids, perm, dtype, idtype, n, rows, cols, table,
        #  vals_a, keys_a, vals_b, keys_b, work, stream)
        lib.rt_scatter_rows_warp.argtypes = [p, p, p, i, i, q, i, i, p, p, p,
                                             p, p, p, p]
        # (src, ids, dtype, idtype, n, rows, cols, blocks, per_block,
        #  partial, table, work, stream)
        lib.rt_scatter_rows_block.argtypes = [p, p, i, i, q, i, i, i, q, p,
                                              p, p, p]
        for fn in (lib.rt_gather_rows, lib.rt_scatter_rows_warp,
                   lib.rt_scatter_rows_block):
            fn.restype = i
        _lib_handle = lib
    return _lib_handle


# ----------------------------------------------------------------------
# Plain versions (CPU tensors)
# ----------------------------------------------------------------------


def gather_plain(table, idx):
    return table[torch.clamp(idx, 0, table.shape[0] - 1)]


def scatter_plain(src, idx, rows):
    """The rows x C table of src's rows (idx.shape + (C,)) summed by
    clamped id: autograd's backward of table[idx]."""
    out = torch.zeros((rows, src.shape[-1]), dtype=src.dtype,
                      device=src.device)
    return out.index_put_((torch.clamp(idx, 0, rows - 1),), src,
                          accumulate=True)


# ----------------------------------------------------------------------
# Kernel wrappers (CUDA tensors)
# ----------------------------------------------------------------------


def _check(name, x, dtypes, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the table on {device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {x.dtype} is not one of "
                         f"{tuple(dtypes)}")


def _call(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"redner_tpu_torch: {fn.__name__} launch failed "
                           f"(cudaError {err})")


def _ids(idx, device):
    _check("idx", idx, _ITYPES, device)
    return idx.reshape(-1).contiguous()


def _work(device):
    """WORK's counters of device when tracing is on (None otherwise, and
    inside a capture that no eager traced launch preceded)."""
    if not timing.get_tracing():
        return None
    acc = WORK.get(device)
    if acc is None and not torch.cuda.is_current_stream_capturing():
        acc = WORK[device] = torch.zeros((2,), dtype=torch.int64,
                                         device=device)
    return acc


def gather_kernel(table, idx):
    """table (R, C) float32/float64 on a card, idx integer of any shape ->
    (*idx.shape, C): one launch of rt_gather_rows."""
    dev = table.device
    _check("table", table, _DTYPES, dev)
    if table.dim() != 2 or table.shape[0] == 0:
        raise ValueError(f"table: want (R >= 1, C), got {tuple(table.shape)}")
    ids = _ids(idx, dev)
    table = table.contiguous()
    rows, cols = table.shape
    out = torch.empty(tuple(idx.shape) + (cols,), dtype=table.dtype,
                      device=dev)
    with torch.cuda.device(dev):
        _call(_lib().rt_gather_rows, table.data_ptr(), ids.data_ptr(),
              _DTYPES[table.dtype], _ITYPES[ids.dtype], ids.numel(), rows,
              cols, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["gather_rows"] += 1
    return out


def scatter_variant(rows, cols, itemsize):
    """"block" for a table of at most BLOCK_TABLE_BYTES, else "warp"."""
    return "block" if rows * cols * itemsize <= BLOCK_TABLE_BYTES else "warp"


def next_level(n):
    """Entries of the warp variant's level after a level of n entries: two a
    tile of 32, none once n fits one tile (csrc/gather.cu next_level)."""
    return 2 * -(-n // 32) if n > 32 else 0


def block_grid(n, size_bytes, sms):
    """(blocks, lanes a block) of the block variant over n >= 1 lanes: a
    block per BLOCK lanes up to one per SM, partials within PARTIAL_BYTES,
    whole warps of consecutive lanes a block."""
    blocks = max(1, min(-(-n // BLOCK), sms, PARTIAL_BYTES // size_bytes))
    per_block = -(-n // blocks)
    per_block = -(-per_block // 32) * 32
    return -(-n // per_block), per_block


def scatter_kernel(src, idx, rows):
    """src (*idx.shape, C) float32/float64 on a card -> the (rows, C) table
    of its rows summed by clamped id: the block variant for a table of at
    most BLOCK_TABLE_BYTES, else the warp variant."""
    dev = src.device
    _check("src", src, _DTYPES, dev)
    ids = _ids(idx, dev)
    cols = src.shape[-1]
    if tuple(src.shape) != tuple(idx.shape) + (cols,):
        raise ValueError(f"src {tuple(src.shape)} is not idx "
                         f"{tuple(idx.shape)} + (C,)")
    if rows <= 0:
        raise ValueError(f"a table of {rows} rows")
    src = src.reshape(-1, cols).contiguous()
    n = ids.numel()
    if n == 0:
        return torch.zeros((rows, cols), dtype=src.dtype, device=dev)
    work = _work(dev)
    wp = 0 if work is None else work.data_ptr()
    kinds = (_DTYPES[src.dtype], _ITYPES[ids.dtype])
    variant = scatter_variant(rows, cols, src.element_size())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if variant == "block":
            blocks, per_block = block_grid(
                n, rows * cols * src.element_size(),
                torch.cuda.get_device_properties(dev).multi_processor_count)
            partial = torch.empty((blocks, rows, cols), dtype=src.dtype,
                                  device=dev)
            table = torch.empty((rows, cols), dtype=src.dtype, device=dev)
            _call(_lib().rt_scatter_rows_block, src.data_ptr(),
                  ids.data_ptr(), *kinds, n, rows, cols, blocks, per_block,
                  partial.data_ptr(), table.data_ptr(), wp, stream)
        else:
            sorted_ids, perm = torch.sort(ids, stable=True)
            a = next_level(n)
            b = next_level(a)
            vals = torch.empty(((a + b) * cols,), dtype=src.dtype,
                               device=dev)
            keys = torch.empty((a + b,), dtype=torch.int32, device=dev)
            table = torch.zeros((rows, cols), dtype=src.dtype, device=dev)
            _call(_lib().rt_scatter_rows_warp, src.data_ptr(),
                  sorted_ids.data_ptr(), perm.data_ptr(), *kinds, n, rows,
                  cols, table.data_ptr(), vals.data_ptr(), keys.data_ptr(),
                  vals[a * cols:].data_ptr(), keys[a:].data_ptr(), wp,
                  stream)
    LAUNCHES["scatter_rows." + variant] += 1
    return table


# ----------------------------------------------------------------------
# Autograd
# ----------------------------------------------------------------------


def _gather(table, idx):
    return gather_kernel(table, idx) if table.is_cuda \
        else gather_plain(table, idx)


def _scatter(src, idx, rows):
    return scatter_kernel(src, idx, rows) if src.is_cuda \
        else scatter_plain(src, idx, rows)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.save_for_forward(idx)
        ctx.rows = table.shape[0]
        return _gather(table, idx)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        return scatter_rows(grad, idx, ctx.rows), None

    @staticmethod
    def jvp(ctx, table_t, _):
        (idx,) = ctx.saved_tensors
        return _gather(table_t, idx)


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx, rows):
        ctx.save_for_backward(idx)
        ctx.save_for_forward(idx)
        ctx.rows = rows
        return _scatter(src, idx, rows)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (idx,) = ctx.saved_tensors
        return gather_rows(grad, idx), None, None

    @staticmethod
    def jvp(ctx, src_t, _, __):
        (idx,) = ctx.saved_tensors
        return _scatter(src_t, idx, ctx.rows)


def gather_rows(table, idx):
    """table (R, C) float, idx integer of any shape -> (*idx.shape, C):
    table[clamp(idx, 0, R - 1)], differentiable in table (its backward is
    scatter_rows)."""
    return _GatherRows.apply(table, idx)


def scatter_rows(src, idx, rows):
    """src (*idx.shape, C) float -> the (rows, C) table of src's rows summed
    by clamp(idx, 0, rows - 1), differentiable in src (its backward is
    gather_rows)."""
    return _ScatterRows.apply(src, idx, rows)
