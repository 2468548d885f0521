"""Lane-split helpers shared by the render and edge paths (port of
redner_tpu/core/shardutil.py).

A pixel sharding (parallel.sharding.pixel_sharding) splits a lane axis over
the ranks of a torch.distributed process group: rank r of `world` takes
one contiguous block, every rank holds the whole scene, and the ranks meet
in three kinds of all-reduce (SUM), each one code path for gloo and NCCL:

  * gather_lanes: each rank writes its lanes into a zero tensor of all
    lanes and the ranks sum it (exact, x + 0 = x); its backward hands each
    rank the adjoint of its own lanes, so nothing is counted twice;
  * all_reduce_sum: population sums over a lane axis (the firefly clamp);
  * reduce_leaf_grads / all_reduce_grads: the scene leaves' gradients,
    once per backward.

A sharding whose group is None (a world of one, torch.distributed not
initialised) makes every one of them a no-op.

Each is capturable in a CUDA graph over an NCCL group (graphs.py): none
reads the host, lane blocks are Python ints from the static mesh, and the
tensors each rank reduces have shapes fixed by the scene's structure (the
leaves' gradients are all-reduced with zeros in place of unused ones).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


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


def capturable(sharding) -> bool:
    """Whether a CUDA graph can hold this sharding's collectives: true
    without a group and for an NCCL group, false for gloo (its collectives
    run on the host)."""
    group = _group(sharding)
    return group is None or dist.get_backend(group) == dist.Backend.NCCL


def all_reduce_sum(x: torch.Tensor, sharding) -> torch.Tensor:
    """x summed over the ranks of the sharding (a new tensor; x itself is
    left as it is)."""
    group = _group(sharding)
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_grads(grads, sharding):
    """Gradients summed over the ranks in one all-reduce (None entries
    stay None; every rank must pass the same pattern of them, which
    render_grad._scene_grads ensures by passing zeros for unused
    leaves)."""
    if _group(sharding) is None:
        return list(grads)
    have = [g for g in grads if g is not None]
    if not have:
        return list(grads)
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in have]), sharding)
    out, at = [], 0
    for g in grads:
        if g is None:
            out.append(None)
            continue
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out


class _GatherLanes(torch.autograd.Function):
    """(local lanes (b, C), start, total, sharding) -> all lanes (total, C):
    the rank's lanes at [start, start + b), the other ranks' elsewhere."""

    @staticmethod
    def forward(ctx, local, start, total, sharding):
        ctx.span = (start, start + local.shape[0])
        full = local.new_zeros((total,) + tuple(local.shape[1:]))
        full[start:start + local.shape[0]] = local
        return all_reduce_sum(full, sharding)

    @staticmethod
    def backward(ctx, grad):
        start, stop = ctx.span
        return grad[start:stop], None, None, None


def gather_lanes(local, start: int, total: int, sharding):
    """All ranks' lanes from each rank's block (see _GatherLanes); without
    a group the one rank's block is all of them."""
    if _group(sharding) is None:
        return local
    return _GatherLanes.apply(local, start, total, sharding)


class _ReduceLeafGrads(torch.autograd.Function):
    """Identity on the leaves; the backward sums their gradients over the
    ranks in one all-reduce."""

    @staticmethod
    def forward(ctx, sharding, *leaves):
        ctx.sharding = sharding
        return tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *all_reduce_grads(grads, ctx.sharding))


def reduce_leaf_grads(leaves, sharding):
    """The leaves, wrapped so that the gradient each receives through the
    result is summed over the ranks (the AD path of a sharded render)."""
    if _group(sharding) is None:
        return list(leaves)
    return list(_ReduceLeafGrads.apply(sharding, *leaves))
