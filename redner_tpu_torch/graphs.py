"""The compiled render: every entry point of the port on a card replayed as
cached CUDA graphs, the port's counterpart of the JAX package's jit caches
(redner_tpu/render_grad.py `_render_cache`, :186-205, with or without a
pixel sharding; redner_tpu/render.py `_render_image_jitted`, :1035-1053,
and jax.grad of it; redner_tpu/parallel/sharding.py `make_train_step`'s
jit, :125; redner_tpu/screen_gradient.py's scan of jvps, :30-75).

A Program holds one key's graphs:

  * forward: a forward-only body on static input tensors, its result in a
    static buffer: render_image's sample loop ("render", "render_image",
    "render_image_grad"), or the screen gradient's jvps and primary-edge
    scatter ("screen_gradient");
  * backward (captured at the first backward): render's whole edge-sampled
    backward (render_grad._scene_grads: the re-render under autograd with
    the fused secondary surrogate, the primary-edge pass and the inner
    autograd.grad), or for "render_image_grad" the same body with both
    edge samplers off at the forward's own options and seed (autograd
    through render_image); the gradients in static buffers.

Inputs: every tensor of the scene (scene.scene_tensors: float leaves and
integer arrays alike, so a scene of the same shapes with other indices
replays as itself) and the seed, an int64 device tensor.  A call copies
them into the program's static tensors and replays.  The key holds what
the graphs bake in, as JAX holds static arguments and aux data: the kind,
the options, the correlated flag, the engine, the scene's structure
(scene.scene_structure: shapes, dtypes, devices, requires_grad and every
non-tensor field), the estimator's module constants and the mesh of a
pixel sharding: its backend, rank, world size, device and process group.
The key holds the group itself, so no two groups share a key, and a key
whose group was destroyed is dropped at the next lookup (its graphs hold
NCCL kernels of a communicator that is gone).

Capture: the body runs once eagerly on a side stream (the warm-up builds
the kernels, makes every kept constant and, under a sharding, runs the
collectives once, which sets up the NCCL communicator outside the graph),
the allocator's cached blocks are freed, then the body is captured.  A
capture that fails raises, with the op that broke it in the exception
chain; nothing falls back to an eager run.  Results handed to the caller
are copies, never the static buffers, so a later replay cannot overwrite
a result the caller kept.

Collectives (pixel_sharding over an NCCL group): every rank builds the
same key and runs the same body, so every rank warms up and then captures
the same collectives in the same order; a replay on each rank runs them
again, paired with the other ranks' replays (or eager calls) by their
order on the communicator.  Only an NCCL group is captured
(core.shardutil.capturable, chosen from the group's backend before
anything is captured): a gloo collective is a host call.  What
ProcessGroupNCCL needs (found on an H100 with PyTorch 2.11 and its NCCL
2.28): nothing beyond the warm-up.  PyTorch records a collective issued
during capture on the capture stream and keeps it off the watchdog's
list of work to poll, so the watchdog queries no event of the graph, and
the default "global" capture mode, which fails a capture on an unsafe
CUDA call from any thread, captures the graphed NCCL routes right after
eager collectives (chip_smoke.py [sharded]).  Async error handling and
the watchdog's timeouts are left as the process has them;
TORCH_NCCL_BLOCKING_WAIT=1 would make each collective wait on the host,
which no capture allows.

disable() runs every entry point eagerly inside it (jax.disable_jit's
counterpart): what launch counting and tracing from Python need.

The cache keeps the programs of CACHE_SIZE keys and evicts the least
recently used one: a program pins its graphs' memory pools, about one
gradient's peak.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import time

import torch
import torch.distributed as dist

from redner_tpu_torch import edge as edge_mod
from redner_tpu_torch.core.shardutil import capturable
from redner_tpu_torch.ops import intersect_cuda as ic
from redner_tpu_torch.scene import (scene_structure, scene_tensors,
                                    scene_with_tensors)

CACHE_SIZE = 4
_cache = collections.OrderedDict()  # key -> Program, least recent first
_disabled = False

# Graphs captured and replayed since import, by graph kind; and of the
# latest capture of each kind, the kernel launches it recorded (the kernel
# nodes each of its replays runs) and its seconds, warm-up included.
CAPTURES = {"forward": 0, "backward": 0}
REPLAYS = {"forward": 0, "backward": 0}
LAST_CAPTURE = {"forward": None, "backward": None}


def _module_constants():
    """The upper-case scalar settings of the modules a render reads at
    each call (edge's estimator constants, the lane target, the mask
    block, ...): a graph bakes their values in, so they key it."""
    # The package exports the function `render`, so the module is looked
    # up by its full name.
    render_mod = importlib.import_module("redner_tpu_torch.render")
    return tuple(
        (m.__name__, k, v) for m in (render_mod, edge_mod, ic)
        for k, v in sorted(vars(m).items())
        if k.isupper() and isinstance(v, (bool, int, float, tuple)))


class _Graph:
    """One captured CUDA graph and its static outputs."""

    def __init__(self, kind, body):
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()  # warm-up
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        self.graph = torch.cuda.CUDAGraph()
        before = dict(ic.LAUNCHES)
        try:
            with torch.cuda.graph(self.graph):
                self.out = body()
        except RuntimeError as e:
            raise RuntimeError(
                f"redner_tpu_torch: CUDA-graph capture of the {kind} failed "
                f"(the chained exception names the op): {e}") from e
        torch.cuda.synchronize()
        self.kind = kind
        CAPTURES[kind] += 1
        LAST_CAPTURE[kind] = {
            "launches": {k: ic.LAUNCHES[k] - before[k] for k in before},
            "seconds": time.perf_counter() - t0}

    def replay(self):
        self.graph.replay()
        REPLAYS[self.kind] += 1


class Program:
    """The graphs of one key, on static copies of a scene's tensors.
    forward_body(scene, seed) -> image; backward_body(scene, seed, ct) ->
    a gradient (or None) per scene_tensors(scene) entry; both are called
    with the static scene and seed (and ct)."""

    def __init__(self, scene, forward_body, backward_body=None):
        self.static = [torch.empty_like(t) for t in scene_tensors(scene)]
        self.scene = scene_with_tensors(scene, self.static)
        self.seed = torch.zeros((), dtype=torch.int64,
                                device=self.static[0].device)
        self.ct = None
        self._forward_body = forward_body
        self._backward_body = backward_body
        self.forward_graph = self.backward_graph = None

    def _load(self, tensors, seed):
        with torch.no_grad():
            for s, t in zip(self.static, tensors):
                s.copy_(t)
            self.seed.copy_(seed)

    def forward(self, tensors, seed):
        """The image of the scene tensors (scene_tensors order) at seed, a
        fresh tensor."""
        self._load(tensors, seed)
        if self.forward_graph is None:
            self.forward_graph = _Graph(
                "forward", lambda: self._forward_body(self.scene, self.seed))
        self.forward_graph.replay()
        return self.forward_graph.out.clone()

    def backward(self, tensors, seed, ct):
        """The gradients of <image, ct>, fresh tensors (None where none)."""
        self._load(tensors, seed)
        if self.ct is None:
            self.ct = torch.empty_like(ct)
        with torch.no_grad():
            self.ct.copy_(ct)
        if self.backward_graph is None:
            self.backward_graph = _Graph(
                "backward",
                lambda: self._backward_body(self.scene, self.seed, self.ct))
        self.backward_graph.replay()
        return tuple(None if g is None else g.clone()
                     for g in self.backward_graph.out)


def _mesh_key(sharding):
    """The mesh of a pixel sharding as a graph bakes it in: the backend,
    this rank, the world size, the device and the group itself (None
    without a group)."""
    if sharding is None:
        return None
    group = sharding.group
    backend = None if group is None else str(dist.get_backend(group))
    return (backend, sharding.rank, sharding.world, str(sharding.device),
            group)


def cache_key(kind, scene, options, correlated, engine, sharding=None):
    """What a program's graphs bake in: the function (kind), the options,
    the correlated flag, the engine, the scene's structure (with the
    devices of its tensors), the module constants and the mesh of the
    pixel sharding."""
    return (kind, options._key(), correlated, engine,
            scene_structure(scene), _module_constants(), _mesh_key(sharding))


def _group_alive(group):
    """Whether a process group is still registered (not destroyed)."""
    try:
        dist.get_backend(group)
    except ValueError:  # no longer in the world's group map
        return False
    return True


def _drop_dead_groups():
    """Drop the programs whose process group was destroyed."""
    for key in list(_cache):
        mesh = key[-1]
        if mesh is not None and mesh[-1] is not None and not _group_alive(
                mesh[-1]):
            del _cache[key]


def program(kind, scene, options, correlated, engine, make, sharding=None):
    """The cached Program of this key, made by make(scene) on a miss; the
    least recently used key goes when the cache is full."""
    _drop_dead_groups()
    key = cache_key(kind, scene, options, correlated, engine, sharding)
    prog = _cache.get(key)
    if prog is None:
        prog = make(scene)
        _cache[key] = prog
        while len(_cache) > CACHE_SIZE:
            _cache.popitem(last=False)
    else:
        _cache.move_to_end(key)
    return prog


def replays(device, sharding=None):
    """Whether an entry point on `device` under `sharding` replays graphs:
    on a card, outside disable(), with no group or an NCCL one (gloo
    collectives are host calls, so a gloo group runs eagerly; the choice
    is made from the backend, before anything is captured)."""
    return (torch.device(device).type == "cuda" and not _disabled
            and capturable(sharding))


@contextlib.contextmanager
def disable():
    """Every entry point runs eagerly inside (jax.disable_jit's
    counterpart): each call runs from Python, so launch counters, patched
    wrappers and tracers see every launch.  The cache is kept."""
    global _disabled
    saved, _disabled = _disabled, True
    try:
        yield
    finally:
        _disabled = saved


def clear():
    """Drop every cached program (and with it the graphs' memory pools)."""
    _cache.clear()
