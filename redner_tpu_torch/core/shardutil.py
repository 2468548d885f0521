"""Lane-split helpers shared by the render and edge paths (port of
redner_tpu/core/shardutil.py).

A pixel sharding (parallel.sharding.pixel_sharding) splits a lane axis over
the ranks of a torch.distributed process group: rank r of `world` takes
one contiguous block, every rank holds the whole scene, and the ranks meet
in all-reduces (SUM), each one code path for gloo and NCCL.  A sharding
whose group is None (a world of one, torch.distributed not initialised)
makes every one of them a no-op.

Forms.  A rank holds each tensor in one of three forms: replicated (the
same value on every rank: the scene leaves, the gathered image, a loss of
it, the reduced gradients), lane-sharded (this rank's lanes) or
rank-partial (this rank's share of a sum over the ranks: a leaf's gradient
from this rank's lanes, the secondary surrogate, a population sum over
this rank's lanes).  The cotangent autograd hands a rank follows from how
the tensor is consumed: a tensor every rank consumes alike (the image, by
a loss of the whole image) gets the whole cotangent on every rank; a
replicated tensor each rank consumes on its own lanes only (the leaves
under a render, the firefly clamp's population scale) gets this rank's
part of it, which must be summed over the ranks.  Each collective below is
a torch.autograd.Function whose backward is the paired conversion, made of
the same Functions, so a backward run under create_graph is differentiable
again (second derivatives):

  * gather_lanes (lane-sharded -> replicated, consumed alike): each rank
    writes its lanes into a zero tensor of all lanes and the ranks sum it
    (exact, x + 0 = x).  Backward: the slice of this rank's lanes
    (_SliceLanes), whose own backward is the gather again; a plain
    grad[start:stop] would pad with zeros in the second pass and never
    sum the ranks.
  * reduce_leaf_grads (replicated leaves consumed on each rank's lanes):
    the identity; its backward sums the leaves' rank-partial gradients
    over the ranks with all_reduce_grads.
  * all_reduce_grads (rank-partial -> replicated, consumed alike: the
    leaves' gradients, which a loss of them or the leaf's accumulated
    .grad reads on every rank alike): the sum; backward the identity,
    since the cotangent of the sum is already the whole one.
  * all_reduce_sum (rank-partial -> replicated, consumed on each rank's
    lanes: the firefly clamp's population sums, edge.firefly_scale): the
    sum; backward the sum of the cotangents over the ranks, the opposite
    convention to the image's gather, because each rank's cotangent of
    the scale holds only its own lanes' part.

Every rank builds the same autograd graph (the same code on the same
shapes; a rank with an empty lane block runs the same ops on empty
tensors), so every pass, the second one included, issues the same
collectives in the same order on every rank.  A collective that fails (a
rank that issued another one times out at the group's timeout) raises
with its number on this rank; nothing runs it again or falls back.

Each collective is capturable in a CUDA graph over an NCCL group
(graphs.py): none reads the host, lane blocks are Python ints from the
static mesh, and the tensors each rank reduces have shapes fixed by the
scene's structure (the leaves' gradients are all-reduced with zeros in
place of unused ones).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from redner_tpu_torch import timing


def shard_count(sharding) -> int:
    """Rank count a sharding splits over (1 for None)."""
    if sharding is None:
        return 1
    return max(int(sharding.world), 1)


def shard_rank(sharding) -> int:
    return 0 if sharding is None else int(sharding.rank)


def lane_block(n: int, rank: int, world: int):
    """(start, stop) of rank `rank`'s block of n lanes: blocks of
    ceil(n / world) lanes in rank order, the last ones shorter or empty."""
    size = -(-n // max(world, 1))
    start = min(rank * size, n)
    return start, min(start + size, n)


def _group(sharding):
    return None if sharding is None else sharding.group


def sharded(sharding) -> bool:
    """Whether the sharding spans ranks through a process group (its
    gradients then go through collectives)."""
    return _group(sharding) is not None


def capturable(sharding) -> bool:
    """Whether a CUDA graph can hold this sharding's collectives: true
    without a group and for an NCCL group, false for gloo (its collectives
    run on the host)."""
    group = _group(sharding)
    return group is None or dist.get_backend(group) == dist.Backend.NCCL




# All-reduces this process has issued, and the (kind, shape) of each while
# a trace_collectives() block records them.
COLLECTIVES = 0
_trace = None


@contextlib.contextmanager
def trace_collectives():
    """Records the (kind, shape) of each all-reduce issued inside, in
    order, into the list it yields (what the ranks compare)."""
    global _trace
    saved, _trace = _trace, []
    try:
        yield _trace
    finally:
        _trace = saved


def _all_reduce(x, group, kind):
    """x summed over the group's ranks in place."""
    global COLLECTIVES
    COLLECTIVES += 1
    if _trace is not None:
        _trace.append((kind, tuple(x.shape)))
    try:
        with timing.phase("collective", x.device, kind=kind):
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    except RuntimeError as e:
        raise RuntimeError(
            f"redner_tpu_torch: all-reduce {COLLECTIVES} of this rank "
            f"({kind}, shape {tuple(x.shape)}) failed; ranks that issue "
            f"different collectives time out at the group's timeout") from e
    return x


class _SumRanks(torch.autograd.Function):
    """Rank-partial -> replicated, the result consumed alike on every rank:
    the sum over the ranks; backward the identity."""

    @staticmethod
    def forward(ctx, x, group, kind):
        return _all_reduce(x.clone(), group, kind)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _SumRanksOnLanes(torch.autograd.Function):
    """Rank-partial -> replicated, the result consumed on each rank's own
    lanes: the sum over the ranks; backward the sum of the (rank-partial)
    cotangents, this Function again."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return _all_reduce(x.clone(), group, kind)

    @staticmethod
    def backward(ctx, grad):
        return (_SumRanksOnLanes.apply(grad, ctx.group,
                                       ctx.kind + " backward"), None, None)


def all_reduce_sum(x: torch.Tensor, sharding) -> torch.Tensor:
    """x (rank-partial) summed over the ranks, for a result each rank
    consumes on its own lanes (the firefly clamp's population sums): its
    gradient sums the ranks' cotangents.  A new tensor; x itself without
    a group."""
    group = _group(sharding)
    if group is None:
        return x
    return _SumRanksOnLanes.apply(x, group, "population sum")


def all_reduce_grads(grads, sharding):
    """Gradients summed over the ranks in one all-reduce (_SumRanks; None
    entries stay None; every rank must pass the same pattern of them,
    which render_grad._scene_grads ensures by passing zeros for unused
    leaves)."""
    group = _group(sharding)
    if group is None:
        return list(grads)
    have = [g for g in grads if g is not None]
    if not have:
        return list(grads)
    flat = _SumRanks.apply(torch.cat([g.reshape(-1) for g in have]), group,
                           "leaf gradients")
    out, at = [], 0
    for g in grads:
        if g is None:
            out.append(None)
            continue
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out


class _GatherLanes(torch.autograd.Function):
    """(local lanes (b, C), start, total, group) -> all lanes (total, C):
    the rank's lanes at [start, start + b), the other ranks' elsewhere.
    Backward: the slice of the rank's own lanes (_SliceLanes)."""

    @staticmethod
    def forward(ctx, local, start, total, group):
        ctx.span = (start, start + local.shape[0], total, group)
        full = local.new_zeros((total,) + tuple(local.shape[1:]))
        full[start:start + local.shape[0]] = local
        return _all_reduce(full, group, "lane gather")

    @staticmethod
    def backward(ctx, grad):
        return _SliceLanes.apply(grad, *ctx.span), None, None, None


class _SliceLanes(torch.autograd.Function):
    """(all lanes, start, stop, total, group) -> this rank's lanes
    [start, stop).  Backward: the gather of every rank's cotangent
    (_GatherLanes), which sums what each rank's lanes contribute."""

    @staticmethod
    def forward(ctx, full, start, stop, total, group):
        ctx.span = (start, total, group)
        return full[start:stop].clone()

    @staticmethod
    def backward(ctx, grad):
        return (_GatherLanes.apply(grad, *ctx.span), None, None, None,
                None)


def gather_lanes(local, start: int, total: int, sharding):
    """All ranks' lanes from each rank's block (see _GatherLanes); without
    a group the one rank's block is all of them."""
    group = _group(sharding)
    if group is None:
        return local
    return _GatherLanes.apply(local, start, total, group)


class _ReduceLeafGrads(torch.autograd.Function):
    """Identity on the leaves, which each rank consumes on its own lanes;
    the backward sums their gradients over the ranks in one all-reduce
    (all_reduce_grads, differentiable under create_graph)."""

    @staticmethod
    def forward(ctx, sharding, *leaves):
        ctx.sharding = sharding
        return tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *all_reduce_grads(grads, ctx.sharding))


def reduce_leaf_grads(leaves, sharding):
    """The leaves, wrapped so that the gradient each receives through the
    result is summed over the ranks (the AD path of a sharded render, and
    the leaves of a sharded backward that records)."""
    if _group(sharding) is None:
        return list(leaves)
    return list(_ReduceLeafGrads.apply(sharding, *leaves))
