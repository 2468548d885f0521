"""The compiled render: `render` and `render_image` on a card replayed as
cached CUDA graphs, the port's counterpart of the JAX package's jit caches
(redner_tpu/render_grad.py `_render_cache`, :186-205, and
redner_tpu/render.py `_render_image_jitted`, :1035-1053).

A Program holds one key's graphs:

  * forward: render_image's sample loop on static input tensors, the image
    in a static buffer;
  * backward (render only, captured at the first backward): the whole
    edge-sampled backward (render_grad._scene_grads: the re-render under
    autograd with the fused secondary surrogate, the primary-edge pass and
    the inner autograd.grad), the gradients in static buffers.

Inputs: every tensor of the scene (scene.scene_tensors: float leaves and
integer arrays alike, so a scene of the same shapes with other indices
replays as itself) and the seed, an int64 device tensor.  A call copies
them into the program's static tensors and replays.  The key holds what
the graphs bake in, as JAX holds static arguments and aux data: the
function, the options, the correlated flag, the engine, the scene's
structure (scene.scene_structure: shapes, dtypes, devices, requires_grad
and every non-tensor field) and the estimator's module constants.

Capture: the body runs once eagerly on a side stream (the warm-up builds
the kernels and makes every kept constant), the allocator's cached blocks
are freed, then the body is captured.  A capture that fails raises, with
the op that broke it in the exception chain; nothing falls back to an
eager run.  Results handed to the caller are copies, never the static
buffers, so a later replay cannot overwrite a result the caller kept.

The cache keeps the programs of CACHE_SIZE keys and evicts the least
recently used one: a program pins its graphs' memory pools, about one
gradient's peak.
"""

from __future__ import annotations

import collections
import importlib
import time

import torch

from redner_tpu_torch import edge as edge_mod
from redner_tpu_torch.ops import intersect_cuda as ic
from redner_tpu_torch.scene import (scene_structure, scene_tensors,
                                    scene_with_tensors)

CACHE_SIZE = 4
_cache = collections.OrderedDict()  # key -> Program, least recent first

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


def cache_key(kind, scene, options, correlated, engine):
    """What a program's graphs bake in: the function (kind), the options,
    the correlated flag, the engine, the scene's structure (with the
    devices of its tensors) and the module constants."""
    return (kind, options._key(), correlated, engine,
            scene_structure(scene), _module_constants())


def program(kind, scene, options, correlated, engine, make):
    """The cached Program of this key, made by make(scene) on a miss; the
    least recently used key goes when the cache is full."""
    key = cache_key(kind, scene, options, correlated, engine)
    prog = _cache.get(key)
    if prog is None:
        prog = make(scene)
        _cache[key] = prog
        while len(_cache) > CACHE_SIZE:
            _cache.popitem(last=False)
    else:
        _cache.move_to_end(key)
    return prog


def clear():
    """Drop every cached program (and with it the graphs' memory pools)."""
    _cache.clear()

