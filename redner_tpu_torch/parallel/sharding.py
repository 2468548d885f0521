"""Multi-GPU rendering and training over torch.distributed (port of
redner_tpu/parallel/sharding.py).

The JAX package runs one controller and lets GSPMD shard the wavefront over
a device mesh.  Here every card runs its own process (SPMD over a
torch.distributed process group, NCCL between cards, gloo on the CPU):

  * the scene is replicated: every rank holds all of it;
  * the per-pixel wavefront is split: rank r of `world` shades one
    contiguous block of the swizzled pixel lanes, padded to a multiple of
    `world` (pad lanes shade pixel order[0] and are dropped), and one block
    of the Morton-sorted primary-edge samples; each lane keeps its global
    pixel or sample id as its RNG key, so every rank draws what one process
    draws for those lanes;
  * the image is gathered with one all-reduce, the secondary edges' firefly
    clamp sums its population statistics over all ranks, and the scene
    leaves' gradients are all-reduced once per backward
    (core/shardutil.py).

Every rank ends with the same image and the same gradients, which equal the
one-process render's.  With torch.distributed not initialised, make_mesh()
is a world of one that needs no collective.

On cards over an NCCL group (or with no group) the entry points replay
cached CUDA graphs with the collectives inside them (graphs.py), as the
JAX package jit-compiles them: render_sharded's forward and edge-sampled
backward, render_image_sharded's forward and, under autograd, its
continuous backward, and so the render and gradient of each
make_train_step step.  Over a gloo group (the CPU, or ranks sharing one
card) they run eagerly; the route follows the group's backend.

Launch one process per card:

    torchrun --nproc_per_node=8 train.py

and in each, `mesh = make_mesh()` (device cuda:LOCAL_RANK), a scene built
on `mesh.device`, then `render_sharded(scene, options, seed, mesh)` or the
step of `make_train_step`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from redner_tpu_torch.device import resolve_device
from redner_tpu_torch.render import RenderOptions, render_image
from redner_tpu_torch.scene import Scene, scene_leaves, scene_with_leaves
from redner_tpu_torch.serialize import named_tensors


@dataclass(frozen=True)
class Mesh:
    """A process group seen from one rank: its rank, the world size and the
    device this rank renders on.  group None: a world of one with no
    collectives (torch.distributed not initialised).  A Mesh is also the
    pixel sharding the render entry points take (pixel_sharding)."""

    group: Optional[object]
    rank: int
    world: int
    device: torch.device

    def check_device(self, device):
        """Raise unless `device` is this rank's device."""
        if _canonical(device) != _canonical(self.device):
            raise ValueError(
                f"redner_tpu_torch: the scene is on {device}, rank "
                f"{self.rank} of the mesh renders on {self.device}")


def _canonical(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(devices=None, group=None) -> Mesh:
    """This rank's view of `group` (the default group when None).

    devices: this rank's device (a torch.device or a string), or a
    sequence indexed by rank; None means cuda:LOCAL_RANK.  Without an
    initialised process group the mesh is a world of one with no
    collectives, as make_mesh() is on a host with one JAX device."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD if group is None else group
        rank, world = dist.get_rank(group), dist.get_world_size(group)
    elif group is not None:
        raise ValueError("a process group was given but torch.distributed "
                         "is not initialised")
    else:
        rank, world = 0, 1
    if devices is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    elif isinstance(devices, (list, tuple)):
        device = devices[rank]
    else:
        device = devices
    return Mesh(group=group, rank=rank, world=world,
                device=resolve_device(device))


def pixel_sharding(mesh: Mesh) -> Mesh:
    """The split of the pixel lanes (and the edge-sample lanes) over mesh
    (jax's NamedSharding over the 'pixels' axis): the mesh itself, whose
    group, rank and world the render and edge paths read."""
    return mesh


def render_image_sharded(scene: Scene, options: RenderOptions, seed=0,
                         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """render_image with the pixels split over the mesh; every rank returns
    the whole image.  Under autograd each leaf's gradient is summed over
    the ranks, so every rank holds the one-process gradient."""
    if mesh is None:
        mesh = make_mesh()
    return render_image(scene, options, seed=seed,
                        pixel_sharding=pixel_sharding(mesh))


def render_sharded(scene: Scene, options: RenderOptions, seed=0,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The edge-sampled render (render_grad.render) with the pixel and
    edge-sample lanes split over the mesh: the forward, the AD re-render,
    and the primary and secondary edge passes all run SPMD."""
    from redner_tpu_torch.render_grad import render

    if mesh is None:
        mesh = make_mesh()
    return render(scene, options, seed=seed,
                  pixel_sharding=pixel_sharding(mesh))


def make_train_step(options: RenderOptions, mesh: Optional[Mesh] = None,
                    learning_rate: float = 1e-2,
                    trainable: Optional[Callable[[str], bool]] = None,
                    use_edge_sampling: bool = True):
    """An SPMD training step: render -> L2 loss against the target ->
    gradient -> SGD update of the scene's float leaves.  Returns
    step(scene, target, seed) -> (scene', loss), the same on every rank.

    use_edge_sampling=True renders with the edge-sampled `render`
    (visibility gradients too); False with render_image (continuous
    gradients only).  Over an NCCL group both replay their forward and
    backward graphs (one capture each, at the second step); the loss and
    the update are a few eager ops.  trainable: a predicate on a leaf's path name, as
    serialize.state_dict names it (e.g. `lambda p: "diffuse" in p`);
    None updates every float leaf."""
    from redner_tpu_torch.render_grad import render

    if mesh is None:
        mesh = make_mesh()
    sharding = pixel_sharding(mesh)

    def step(scene, target, seed):
        leaves = scene_leaves(scene)
        path_of = {id(t): p for p, t in named_tensors(scene).items()}
        train = [trainable is None or trainable(path_of[id(x)])
                 for x in leaves]
        xs = [x.detach().requires_grad_(t) for x, t in zip(leaves, train)]
        s = scene_with_leaves(scene, xs)
        if use_edge_sampling:
            img = render(s, options, seed=seed, pixel_sharding=sharding)
        else:
            img = render_image(s, options, seed=seed,
                               pixel_sharding=sharding)
        target = torch.as_tensor(target, dtype=img.dtype, device=img.device)
        loss = torch.mean((img - target) ** 2)
        wrt = [x for x in xs if x.requires_grad]
        grads = iter(torch.autograd.grad(loss, wrt, allow_unused=True)
                     if wrt else ())
        new = []
        for x in xs:
            g = next(grads) if x.requires_grad else None
            new.append(x.detach() if g is None
                       else x.detach() - learning_rate * g)
        return scene_with_leaves(scene, new), loss.detach()

    return step
