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
    through render_image); the gradients in static buffers.  A key that
    keeps its residuals (below) walks the forward graph's tape instead.

A key whose backward renders exactly the forward's image (render_grad:
correlated, the backward's sample count the forward's, no secondary
edge, no remat, no pixel sharding) is a KeptProgram, the design of
torch.cuda.make_graphed_callables: its forward graph runs the sample
loop under autograd on the static tensors and keeps the tape behind its
static image; its backward graph, captured in the forward graph's pool,
takes autograd.grad through that tape (with the primary-edge pass where
it is on) and loads no scene tensor.  The capture frees the tape as the
walk goes, so the gradients reuse its blocks.  The two graphs are a
pair: releasing either releases both, and the next call captures both
again.  Each call's autograd ctx holds the program's forward generation
(bumped by every forward replay and every release); a backward whose
generation is no longer the program's (a second forward of the key
replayed before it, as in a loop over views) runs the re-render body on
its own saved tensors instead, in a Program of its own (the fallback:
its own static tensors and pool, captured on its second need).  The
eager first call of a key keeps its eager tape on its ctx.

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

Capture: a key's first call of each graph kind runs its body eagerly
(it builds the kernels, makes every kept constant and, under a sharding,
runs the collectives once, which sets up the NCCL communicator outside the
graph) and measures the device memory the run needs: the reserved bytes
it added after the allocator's unused blocks were returned.  The next call
captures the body and replays it.  A capture that fails raises, with the
op that broke it in the exception chain; nothing falls back to an eager
run.  Results handed to the caller are copies, never the static buffers,
so a later replay cannot overwrite a result the caller kept.

Collectives (pixel_sharding over an NCCL group): every rank builds the
same key and runs the same body, and every call of a program runs the
body's collectives exactly once, whatever route the call takes: an eager
run, a replay, or a capture (which records the collectives without
running them) followed by its replay.  So a rank's choices of route,
which follow its own card's free memory, never change how many
collectives it issues, and each call's collectives pair with the other
ranks' by their order on the communicator.  Only an NCCL group is
captured (core.shardutil.capturable, chosen from the group's backend
before anything is captured): a gloo collective is a host call.  What
ProcessGroupNCCL needs (found on an H100 with PyTorch 2.11 and its NCCL
2.28): nothing beyond the first, eager call.  PyTorch records a
collective issued during capture on the capture stream and keeps it off
the watchdog's list of work to poll, so the watchdog queries no event of
the graph, and the default "global" capture mode, which fails a capture
on an unsafe CUDA call from any thread, captures the graphed NCCL routes
right after eager collectives (chip_smoke.py [sharded]).  Async error
handling and the watchdog's timeouts are left as the process has them;
TORCH_NCCL_BLOCKING_WAIT=1 would make each collective wait on the host,
which no capture allows.

disable() runs every entry point eagerly inside it (jax.disable_jit's
counterpart): what launch counting and tracing from Python need.

The cache is bounded by the device memory its graphs keep.  A program
pins its graphs' memory pools, about one gradient's peak (Program.bytes:
the reserved memory each capture added).  Room is made by releasing
graphs: other programs' on the same card, least recently used first,
then the key's own graphs of other kinds, until the card's free memory
covers what comes next.  Before a capture that is CAPTURE_MARGIN x the
measured need of the graph, plus that of the key's other graph when it
is not held (so that the two fit together); if the card cannot hold
them with every other program's graphs released, the key runs eagerly
from then on (Program.eager, counted in EAGER["memory"]).  The choice is
made from measured bytes and the card's memory before anything is
captured, never by catching an out-of-memory error.  Before every eager
run (a key's first call, every call of a key that runs eagerly, a
backward that records) room is made for the run's need as measured at
its last run, the allocator's unused blocks counted as free (the cache
is emptied, which waits for the card, only when they do not cover it); a
run not measured yet releases every other graph on the card first, after
an empty_cache.  A program keeps its measurements when its graphs are
released, so it captures again without an eager run.  A program that a
pending autograd ctx holds stays valid: a released graph is captured
again at its next call.  CACHE_SIZE bounds the number of keys besides.

Tracing (timing.set_tracing): a call's steps are host spans, in the
order a call takes them: `cache.lookup` (program(): the key, the scene's
structure and the module constants, every call), `cache.load` (the
inputs copied into the static tensors), `cache.replay`, `cache.copy` (the
outputs cloned), `cache.eager` (with its cause: first, memory or
create_graph), `cache.capture` and `cache.make_room`.  The key holds the
tracing flag, so a graph captured with tracing on (its phases' events and
ray-query counters baked in) never replays for an untraced call, and one
captured with tracing off holds neither.  Counters, always on: RELEASED,
EMPTY_CACHE and FIRST_RUN beside EAGER, CAPTURES, REPLAYS and
LAST_CAPTURE.

A backward asked to record (torch.autograd.grad(..., create_graph=True):
grad enabled inside the backward), and the backward of a render that
differentiates such a recorded gradient, do not replay: render_grad runs
them eagerly on the saved tensors, whose history the second derivative
needs (Program.run_eagerly("create_graph", ...), EAGER["create_graph"]).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import importlib
import time

import torch
import torch.distributed as dist

from redner_tpu_torch import edge as edge_mod
from redner_tpu_torch import timing
from redner_tpu_torch.core.shardutil import capturable
from redner_tpu_torch.ops import intersect_cuda as ic
from redner_tpu_torch.scene import (scene_structure, scene_tensors,
                                    scene_with_tensors)

CACHE_SIZE = 4  # keys, at most
# A graph pool's reserved bytes over its body's measured need: the pools
# keep whole segments (PERF.md: 43212.0 MiB kept for a 41926.8 MiB peak).
CAPTURE_MARGIN = 1.05
KINDS = ("forward", "backward")  # the graphs of a program
_cache = collections.OrderedDict()  # key -> Program, least recent first
_disabled = False

# Calls that ran eagerly on a card outside disable(), by cause: a
# backward that records (create_graph) and a key whose graphs do not fit.
EAGER = {"create_graph": 0, "memory": 0}

# Graphs captured and replayed since import, by graph kind; and of the
# latest capture of each kind, the kernel launches it recorded (the kernel
# nodes each of its replays runs), its seconds and its reserved bytes.
CAPTURES = {"forward": 0, "backward": 0}
REPLAYS = {"forward": 0, "backward": 0}
LAST_CAPTURE = {"forward": None, "backward": None}

# Backwards of render and render_image under autograd on the graphed
# route, by how they got their gradients: through the forward's kept
# autograd residuals ("kept"), or by rendering again, for a key whose
# backward's image is not the forward's ("ineligible"), a ctx whose
# forward graph has replayed since or was released ("overwritten"), or a
# backward that records (create_graph, run eagerly).
BACKWARDS = {"kept": 0, "ineligible": 0, "overwritten": 0, "create_graph": 0}

# Graphs released to make room; _device_free calls that emptied the
# allocator's cache (and so waited for the card); and the seconds of each
# key's first eager run of a graph kind, synchronised at both ends (the
# run that builds the kernels and measures the need), summed by kind.
RELEASED = 0
EMPTY_CACHE = 0
FIRST_RUN = {"forward": 0.0, "backward": 0.0}


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


def _unused(device):
    """The allocator's unused bytes on the card that an allocation can
    have: reserved but not allocated, less the free parts of segments
    that are partly in use (they cannot go back to the card) and the
    bytes the cached graphs' pools keep (their free blocks serve only
    their graphs).  An allocation that finds no room returns the rest to
    the card and tries again."""
    split = torch.cuda.memory_stats(device).get(
        "inactive_split_bytes.all.current", 0)
    pooled = sum(p.bytes for p in _cache.values() if p.device == device)
    return max(torch.cuda.memory_reserved(device)
               - torch.cuda.memory_allocated(device) - split - pooled, 0)


def _device_free(device, need=None):
    """The bytes a run on the card can allocate.  With a measured need:
    the card's free memory plus the allocator's unused blocks (_unused),
    when those cover it; else, and when need is None (not measured yet,
    or a capture, whose private pool comes from the card's free memory),
    the card's free memory after the unused blocks are returned
    (empty_cache, which waits for the card)."""
    global EMPTY_CACHE
    free = torch.cuda.mem_get_info(device)[0]
    if need is not None:
        free += _unused(device)
        if free >= need:
            return free
    EMPTY_CACHE += 1
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info(device)[0]


def _measured(body, device):
    """body() run eagerly -> (its result, the reserved bytes the run
    added: what it needed beyond the blocks in use or cached before it;
    the first run of a kind follows an empty_cache (_device_free), so its
    measure is the whole need, and later runs keep the largest).  The
    caller's peak-memory statistics are left as they are."""
    before = torch.cuda.memory_reserved(device)
    out = body()
    return out, torch.cuda.memory_reserved(device) - before


def _make_room(need, keep, spare=(), eager=False):
    """Releases graphs on keep's card until its free memory covers `need`
    bytes: the other programs' (least recently used first), then keep's
    own graphs of the kinds in `spare`; every one of them when need is
    None (not measured yet).  For an eager run the allocator's unused
    blocks count as free, so the cache is emptied only when they do not
    cover need (_device_free); a capture's pool needs the card's free
    memory.  Whether the free memory covers need."""
    global RELEASED
    with timing.span("cache.make_room"):
        ask = need if eager else None
        free = _device_free(keep.device, ask)
        held = [(p, k) for p in _programs()
                if p is not keep and p.device == keep.device for k in KINDS]
        for prog, kind in held + [(keep, k) for k in spare]:
            if need is not None and free >= need:
                break
            released = prog.release((kind,))
            if released:
                RELEASED += released
                gc.collect()  # the pool goes with the last reference
                free = _device_free(keep.device, ask)
        return need is not None and free >= need


def _programs():
    """Every cached program and the fallback it holds."""
    for prog in _cache.values():
        yield prog
        if getattr(prog, "fallback", None) is not None:
            yield prog.fallback


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _copy(out):
    """Fresh tensors of a graph's outputs (an image, or gradients with
    None)."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    return tuple(None if g is None else g.clone() for g in out)


class _Graph:
    """One captured CUDA graph, its static outputs and the reserved bytes
    its capture added; captured with tracing on, its phases' events
    (timing.GraphTrace) and the ray-query lanes each replay launches.
    pool: another graph's memory pool to capture into (its pool())."""

    def __init__(self, kind, body, device, pool=None):
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        before = dict(ic.LAUNCHES)
        lanes = {k: w["captured"] for k, w in ic.WORK.items()}
        reserved = torch.cuda.memory_reserved(device)
        try:
            with timing.capture() as trace, torch.cuda.graph(self.graph,
                                                             pool=pool):
                self.out = body()
        except RuntimeError as e:
            raise RuntimeError(
                f"redner_tpu_torch: CUDA-graph capture of the {kind} failed "
                f"(the chained exception names the op): {e}") from e
        torch.cuda.synchronize(device)
        self.bytes = torch.cuda.memory_reserved(device) - reserved
        self.kind = kind
        self.trace = trace if trace.batches else None
        self.lanes = {k: w["captured"] - lanes[k]
                      for k, w in ic.WORK.items()}
        CAPTURES[kind] += 1
        LAST_CAPTURE[kind] = {
            "launches": {k: ic.LAUNCHES[k] - before[k] for k in before},
            "seconds": time.perf_counter() - t0, "bytes": self.bytes}

    def pool(self):
        return self.graph.pool()

    def replay(self):
        if self.trace is not None:
            # The previous replay's phases are read (which may wait for the
            # card) before the span, so cache.replay times the launch alone.
            self.trace.read()
        with timing.span("cache.replay"):
            if self.trace is None:
                self.graph.replay()
            else:
                self.trace.replay(self.graph)
                for k, n in self.lanes.items():
                    ic.WORK[k]["lanes"] += n
        REPLAYS[self.kind] += 1


class Program:
    """The graphs of one key, on static copies of a scene's tensors.
    forward_body(scene, seed) -> image; backward_body(scene, seed, ct) ->
    a gradient (or None) per scene_tensors(scene) entry; both are called
    with the static scene and seed (and ct)."""

    def __init__(self, scene, forward_body, backward_body=None):
        self.static = [torch.empty_like(t) for t in scene_tensors(scene)]
        self.scene = scene_with_tensors(scene, self.static)
        self.device = self.static[0].device
        self.seed = torch.zeros((), dtype=torch.int64, device=self.device)
        self.ct = None
        self._forward_body = forward_body
        self._backward_body = backward_body
        self.graphs = dict.fromkeys(KINDS)
        self.needs = {}  # run kind -> the reserved bytes its last run added
        self.eager = False  # the key's graphs do not fit the card

    @property
    def bytes(self):
        """The reserved bytes this program's graphs keep."""
        return sum(g.bytes for g in self.graphs.values() if g is not None)

    def _load(self, tensors, seed):
        with timing.span("cache.load"), torch.no_grad():
            for s, t in zip(self.static, tensors):
                s.copy_(t)
            self.seed.copy_(seed)

    def _forward(self):
        return self._forward_body(self.scene, self.seed)

    def _backward(self):
        return self._backward_body(self.scene, self.seed, self.ct)

    def release(self, kinds=KINDS):
        """Drops the graphs of `kinds`; the number dropped."""
        dropped = sum(self.graphs[k] is not None for k in kinds)
        for k in kinds:
            self.graphs[k] = None
        return dropped

    def run_eagerly(self, kind, body):
        """body() run eagerly, after room is made on the card for the need
        its kind measured at its last run (the key's own graphs of other
        kinds released last); the need of this run kept.  A graph kind's
        first run is timed into FIRST_RUN."""
        first = kind in KINDS and kind not in self.needs
        cause = ("create_graph" if kind == "create_graph" else
                 "memory" if self.eager else "first")
        with timing.span("cache.eager", cause=cause):
            _make_room(self.needs.get(kind), self,
                       [k for k in KINDS if k != kind], eager=True)
            if first:
                _sync(self.device)
                t0 = time.perf_counter()
            out, need = _measured(body, self.device)
            if first:
                _sync(self.device)
                FIRST_RUN[kind] += time.perf_counter() - t0
        self.needs[kind] = max(need, self.needs.get(kind, 0))
        return out

    def _run(self, kind):
        """The graph `kind` replayed (captured first if its body has run
        and it fits the card), or its body run eagerly; fresh tensors."""
        graph = self.graphs[kind]
        if graph is None and kind in self.needs and not self.eager:
            graph = self._capture(kind)
        if graph is not None:
            graph.replay()
            with timing.span("cache.copy"):
                return _copy(graph.out)
        if self.eager:
            EAGER["memory"] += 1
        return self.run_eagerly(kind, getattr(self, "_" + kind))

    def _capture(self, kind):
        """The graph of `kind`, captured once the card has room for it and
        for the key's other graph where that is measured but not held;
        else None, and the key runs eagerly from then on."""
        with timing.span("cache.capture", kind=kind):
            need = CAPTURE_MARGIN * sum(
                self.needs[k] for k in KINDS
                if k in self.needs and (k == kind or self.graphs[k] is None))
            if not _make_room(need, self):
                self.eager = True
                self.release()
                return None
            self.graphs[kind] = self._new_graph(kind)
            return self.graphs[kind]

    def _new_graph(self, kind):
        return _Graph(kind, getattr(self, "_" + kind), self.device)

    def forward(self, tensors, seed):
        """The image of the scene tensors (scene_tensors order) at seed, a
        fresh tensor."""
        self._load(tensors, seed)
        return self._run("forward")

    def backward(self, tensors, seed, ct):
        """The gradients of <image, ct>, fresh tensors (None where none)."""
        self._load(tensors, seed)
        if self.ct is None:
            self.ct = torch.empty_like(ct)
        with torch.no_grad():
            self.ct.copy_(ct)
        return self._run("backward")


class _Tape:
    """An eager forward's residuals: its image, carrying the autograd
    graph, and the scene of leaves and the seed it rendered from."""

    def __init__(self, image, scene, seed):
        self.image, self.scene, self.seed = image, scene, seed


class KeptProgram(Program):
    """A Program whose backward graph takes autograd.grad through the
    forward graph's own tape (see the module's docstring).  needs: which
    scene tensors the gradients are for.  forward_body(scene, seed) ->
    the image, rendered under autograd; backward_body(scene, seed, ct) ->
    a gradient (or None) per scene tensor by rendering again, as a
    Program's (the fallback's); kept_body(image, scene, seed, ct, retain)
    -> the same gradients through the tape behind image (kept where
    retain).  forward() and backward() take and give the residuals' token
    of a call: its generation, or its eager _Tape."""

    def __init__(self, scene, needs, forward_body, backward_body,
                 kept_body):
        super().__init__(scene, forward_body, backward_body)
        self.needs_grad = list(needs)
        # The forward graph renders from the static tensors under version
        # counters of their own (.data): a call's load writes them outside
        # autograd, and the tape is captured against them, so a later
        # load never fails the saved tensors' version check at the
        # backward's capture.
        self.scene = scene_with_tensors(scene, [
            s.data.requires_grad_(n) for s, n in zip(self.static, needs)])
        self.generation = 0
        self._kept_body = kept_body
        self.fallback = None

    @property
    def bytes(self):
        own = super().bytes
        return own + (0 if self.fallback is None else self.fallback.bytes)

    def release(self, kinds=KINDS):
        """Drops both graphs (a pair goes whole) and moves the generation
        on: a pending ctx's residuals are gone."""
        self.generation += 1
        return super().release(KINDS)

    def _capture(self, kind):
        """A forward's capture captures the backward beside it, into its
        pool, when the backward is measured (make_graphed_callables'
        order); else the backward is captured at its first measured need,
        through the same tape."""
        graph = super()._capture(kind)
        if graph is not None and kind == "forward":
            if self.ct is None:
                self.ct = torch.empty_like(graph.out)
            if "backward" in self.needs and super()._capture(
                    "backward") is None:
                return None
        return graph

    def _new_graph(self, kind):
        if kind == "forward":
            return super()._new_graph(kind)
        return _Graph(kind, self._backward, self.device,
                      pool=self.graphs["forward"].pool())

    def _backward(self):
        return self._kept_body(self.graphs["forward"].out, self.scene,
                               self.seed, self.ct, False)

    def forward(self, tensors, seed):
        """(the image of the scene tensors at seed, a fresh tensor; the
        token of its residuals)."""
        self._load(tensors, seed)
        graph = self.graphs["forward"]
        if graph is None and "forward" in self.needs and not self.eager:
            graph = self._capture("forward")
        if graph is not None:
            graph.replay()
            self.generation += 1
            with timing.span("cache.copy"):
                return _copy(graph.out), self.generation
        if self.eager:
            EAGER["memory"] += 1

        def body():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(tensors, self.needs_grad)]
            scene = scene_with_tensors(self.scene, leaves)
            return _Tape(self._forward_body(scene, seed), scene, seed)

        tape = self.run_eagerly("forward", body)
        with torch.no_grad():
            return _copy(tape.image), tape

    def backward(self, token, tensors, seed, ct):
        """The gradients of <image, ct> (fresh tensors, None where none)
        for the call whose residuals' token this is: through its eager
        tape, or the forward graph's while the generation is the call's,
        else by the fallback's re-render of its tensors.  A call's
        residuals serve one backward: the walk frees an eager tape, and
        the backward graph's gradients reuse the forward graph's blocks."""
        if isinstance(token, _Tape) and token.image is not None:
            image, token.image = token.image, None
            BACKWARDS["kept"] += 1
            if self.eager:
                EAGER["memory"] += 1
            return self.run_eagerly("backward", lambda: self._kept_body(
                image, token.scene, token.seed, ct, False))
        if (token == self.generation and self.graphs["backward"] is None
                and "backward" in self.needs and not self.eager):
            self._capture("backward")  # releases the pair where it cannot
        if token != self.generation:
            BACKWARDS["overwritten"] += 1
            if self.fallback is None:
                self.fallback = Program(self.scene, None,
                                        self._backward_body)
            return self.fallback.backward(tensors, seed, ct)
        BACKWARDS["kept"] += 1
        self.generation += 1
        graph = self.graphs["backward"]
        if graph is None:
            # Not measured yet: run on the forward graph's tape, kept for
            # the capture to come.
            tape = self.graphs["forward"].out
            return self.run_eagerly("backward", lambda: self._kept_body(
                tape, self.scene, self.seed, ct, True))
        self.ct.copy_(ct)
        graph.replay()
        with timing.span("cache.copy"):
            return _copy(graph.out)


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
    devices of its tensors), the module constants, the tracing flag (a
    traced graph holds its phases' events and work counters) and, last,
    the mesh of the pixel sharding."""
    return (kind, options._key(), correlated, engine,
            scene_structure(scene), _module_constants(),
            timing.get_tracing(), _mesh_key(sharding))


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
    with timing.span("cache.lookup"):
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


def cached_bytes():
    """The reserved bytes the cached programs' graphs keep, by key."""
    return {key: prog.bytes for key, prog in _cache.items()}


def clear():
    """Drop every cached program (and with it the graphs' memory pools)."""
    _cache.clear()
