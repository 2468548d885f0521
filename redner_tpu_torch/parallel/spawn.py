"""Ranks of a torch.distributed process group spawned on this host.

For a script, `torchrun --nproc_per_node=N` starts the ranks; run_ranks
does the same from inside a program: the port's CPU tests run gloo ranks
with it, and chip_smoke.py two ranks on one card (gloo) or one rank a card
(NCCL).  torch.multiprocessing.spawn re-imports the module of the function
each child runs, so that module must import cheaply and without side
effects.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


def _entry(rank, world, init_file, backend, fn, args, out_dir):
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world, fn, args, tmp_dir, backend="gloo"):
    """fn(*args) on `world` ranks (spawned processes) of a `backend` process
    group with a file rendezvous in tmp_dir; returns each rank's result, in
    rank order.  A rank that raises ends the others and raises here."""
    tmp_dir = str(tmp_dir)
    init_file = os.path.join(tmp_dir, "rendezvous")
    mp.spawn(_entry, args=(world, init_file, backend, fn, args, tmp_dir),
             nprocs=world, join=True)
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False)
            for r in range(world)]
