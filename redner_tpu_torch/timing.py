"""Timing, tracing and profiling (port of redner_tpu/timing.py; reference
pyredner.set_print_timing, pyredner/render_pytorch.py:31-44).

Print timing: `set_print_timing(True)` makes `timed(label)` blocks print
their wall time.

Tracing: `set_tracing(True)` makes the port keep, in memory, what its
calls do; `records()` returns it as Span records (call id, span id,
parent id, name, start, end, attrs, device seconds):

  * host spans (`span(name, **attrs)`), on time.perf_counter: the entry
    points (`entry`, one call id for every span of a call and of its
    backward), the graph cache's `cache.*` steps, `timed` blocks;
  * device phases (`phase(name, device, **attrs)`): a host span whose
    device time a pair of timing events takes on the current stream.
    Recorded inside a CUDA-graph capture, the events are event-record
    nodes of the graph (external events), so every replay times the
    phase again: a replayed phase is a record with device seconds and
    no host times, parented by the replaying call's `cache.replay` span.
    A graph's times are read before its next replay (waiting for the
    previous one only when the host ran ahead of the card) or by
    `records()`.  On CPU tensors a phase is a host span;
  * backward phases: under autograd a phase marks its differentiable
    inputs and outputs (`enter`, `exit`) with identity autograd
    Functions; the output mark's backward opens `bwd:<phase>`, the input
    mark's backward closes it.  The input mark is not on the data path
    (its backward returns no gradient), and the output mark takes only
    tensors the phase made, so no gradient is summed in another order.
    Inside an `autograd` phase the marks' events split its device time:
    each stretch between two marks goes to the open `bwd:<phase>` or to
    `autograd.other`, so the two add up to `autograd`.  A whole-body
    phase (`fwd`, `bwd`) names the graph of the phases inside it (their
    `graph` attribute) and reports what its direct children leave as
    `<fwd|bwd>.other`.

With tracing off, `span`, `phase` and `timed` cost one check of a module
flag and return a shared no-op.  `profile_trace(dir)` records a
torch.profiler trace of its block, with tracing on inside it (each span
is also a record_function of its name while a profiler records), and
writes it to `dir` as a Chrome trace (chrome://tracing, Perfetto)."""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import time

import torch

from redner_tpu_torch.device import use_gpu

_print_timing = False
_tracing = False

WHOLE_BODY = ("fwd", "bwd")  # the phase that holds a graph's whole body


def set_print_timing(v: bool):
    global _print_timing
    _print_timing = bool(v)


def get_print_timing() -> bool:
    return _print_timing


def set_tracing(v: bool):
    """Record spans, device phases and ray-query work from now on (a graph
    captured with tracing on holds its phases' events; the graph cache
    keys on the flag)."""
    global _tracing
    _tracing = bool(v)


def get_tracing() -> bool:
    return _tracing


class Span:
    """One record: a host span (start/end on time.perf_counter), a device
    phase (device: its seconds on the card, None on the CPU or until read)
    or a replayed phase (no host times)."""

    __slots__ = ("call", "id", "parent", "name", "start", "end", "attrs",
                 "device")

    def __init__(self, call, id, parent, name, start, end, attrs,  # noqa: A002
                 device=None):
        self.call, self.id, self.parent, self.name = call, id, parent, name
        self.start, self.end, self.attrs, self.device = (start, end, attrs,
                                                         device)

    @property
    def seconds(self):
        """Host seconds; None for a replayed phase."""
        if self.start is None or self.end is None:
            return None
        return self.end - self.start

    def __repr__(self):
        return (f"Span({self.name!r}, call={self.call}, id={self.id}, "
                f"parent={self.parent}, seconds={self.seconds}, "
                f"device={self.device}, attrs={self.attrs})")


_records = []  # finished spans, in the order they closed or were read
_open = []  # open spans, innermost last
_ids = itertools.count(1)
_calls = itertools.count(1)
_graph = None  # the open whole-body phase's name
_batch = None  # the device phases of the open outermost device phase
_sink = None  # the GraphTrace of a capture in progress
_pending = []  # eager batches not read yet
_replayed = set()  # GraphTraces whose latest replay is not read yet
_loose = {}  # output-mark key -> (rec, event, host time): a backward
# phase on the card outside any device phase


class _Null:
    """The no-op span and phase of tracing off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def enter(self, *inputs):
        pass

    def exit(self, outputs):
        return outputs


_NULL = _Null()


def _profiling():
    return torch.autograd.profiler._is_profiler_enabled


class _SpanCM:
    __slots__ = ("name", "attrs", "call", "span", "rf")

    def __init__(self, name, attrs, call=None):
        self.name, self.attrs, self.call = name, attrs, call

    def __enter__(self):
        parent = _open[-1] if _open else None
        if parent is not None:
            call = parent.call
        else:
            call = self.call if self.call is not None else next(_calls)
        self.span = Span(call, next(_ids), None if parent is None
                         else parent.id, self.name, time.perf_counter(),
                         None, self.attrs)
        _open.append(self.span)
        self.rf = None
        if _profiling():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        s = self.span
        s.end = time.perf_counter()
        if _open and _open[-1] is s:
            _open.pop()
        elif s in _open:
            _open.remove(s)
        _records.append(s)
        return False


def span(name, **attrs):
    """A host span around the block (no-op with tracing off)."""
    if not _tracing:
        return _NULL
    return _SpanCM(name, attrs)


def entry(name, call=None):
    """The span of an entry call: a new call id, or `call` (a backward
    joining its forward's call); inside another call's span it joins
    that call."""
    if not _tracing:
        return _NULL
    _flush(False)
    return _SpanCM(name, {}, call)


def current_call():
    """The open call's id (None with nothing open or tracing off)."""
    return _open[-1].call if (_tracing and _open) else None


def _event(device=None):
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Batch:
    """The device phases of one outermost device phase, in closing order
    ([(span, start event, end event)]), and the backward marks recorded
    inside it ([(kind, rec, event, host time, autograd span id)])."""

    __slots__ = ("phases", "marks")

    def __init__(self):
        self.phases, self.marks = [], []

    def last_event(self):
        return self.phases[-1][2]


class _Rec:
    """What a mark's backward knows of its forward phase."""

    __slots__ = ("key", "name", "attrs", "cuda", "call")

    def __init__(self, key, name, attrs, cuda, call):
        self.key, self.name, self.attrs = key, name, attrs
        self.cuda, self.call = cuda, call


def _tensors(tree):
    """The tensors of a nest of dataclasses, tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name, None))
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _mark(rec, kind):
    """A backward mark: `start` (the phase's outputs have their
    gradients) or `end` (its inputs have theirs)."""
    t = time.perf_counter()
    parent = _open[-1] if _open else None
    if not rec.cuda or _batch is None:
        if kind == "start":
            _loose[rec.key] = (rec, _event() if rec.cuda else None, t,
                               parent)
            return
        got = _loose.pop(rec.key, None)
        if got is None:
            return
        _, ev0, t0, parent = got
        call = parent.call if parent is not None else rec.call
        s = Span(call, next(_ids), None if parent is None else parent.id,
                 "bwd:" + rec.name, t0, t, rec.attrs)
        _records.append(s)
        if rec.cuda:
            b = _Batch()
            b.phases.append((s, ev0, _event()))
            _pending.append(b)
        return
    autograd = next((s.id for s in reversed(_open) if s.name == "autograd"),
                    None)
    _batch.marks.append((kind, rec, _event(), t, autograd))


class _Enter(torch.autograd.Function):
    """The input mark: no output anyone reads; its backward, run once the
    phase's own backward has run, ends the backward phase and returns no
    gradient."""

    @staticmethod
    def forward(ctx, rec, *xs):
        ctx.rec = rec
        ctx.set_materialize_grads(False)
        return xs[0].new_empty((0,))

    @staticmethod
    def backward(ctx, _):
        _mark(ctx.rec, "end")
        return (None,) * (len(ctx.needs_input_grad))


class _Exit(torch.autograd.Function):
    """The output mark: the identity on the phase's outputs (and the input
    mark's token, whose gradient is none); its backward starts the
    backward phase."""

    @staticmethod
    def forward(ctx, rec, token, *xs):
        ctx.rec = rec
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        _mark(ctx.rec, "start")
        return (None, None, *grads)


class _PhaseCM(_SpanCM):
    __slots__ = ("device", "cuda", "root", "ev0", "saved", "rec", "token",
                 "seq")

    def __init__(self, name, device, attrs):
        super().__init__(name, attrs)
        self.device = device
        self.cuda = device is not None and torch.device(device).type == "cuda"

    def __enter__(self):
        global _graph, _batch
        self.saved = _graph
        if self.name in WHOLE_BODY:
            _graph = self.name
        elif _graph is not None:
            self.attrs["graph"] = _graph
        super().__enter__()
        self.root = False
        if self.cuda:
            if _batch is None:
                _batch, self.root = _Batch(), True
            self.ev0 = _event(self.device)
        self.rec = self.token = self.seq = None
        return self

    def __exit__(self, *exc):
        global _graph, _batch
        if self.cuda and _batch is not None:
            _batch.phases.append((self.span, self.ev0, _event(self.device)))
        super().__exit__(*exc)
        _graph = self.saved
        if self.root:
            batch, _batch = _batch, None
            (_sink.batches if _sink is not None else _pending).append(batch)
        return False

    def enter(self, *inputs):
        """Marks the phase's differentiable inputs (any nest of tensors):
        the end of its backward phase."""
        if not torch.is_grad_enabled():
            return
        xs = [x for x in _tensors(inputs) if x.requires_grad]
        self.rec = _Rec(self.span.id, self.name, self.attrs, self.cuda,
                        self.span.call)
        if xs:
            self.token = _Enter.apply(self.rec, *xs)
            self.seq = self.token.grad_fn._sequence_nr()

    def exit(self, outputs):
        """The phase's outputs (a nest of tensors), those it made that
        carry gradients passed through the output mark: the start of its
        backward phase."""
        if self.rec is None:
            return outputs
        seen = {}
        for x in _tensors(outputs):
            fn = x.grad_fn
            if (x.requires_grad and fn is not None and id(x) not in seen
                    and (self.seq is None or fn._sequence_nr() > self.seq)):
                seen[id(x)] = x
        if not seen:
            return outputs
        marked = _Exit.apply(self.rec, self.token, *seen.values())
        out = dict(zip(seen, marked))
        return _tree_map(lambda x: out.get(id(x), x), outputs)


def phase(name, device=None, **attrs):
    """A device phase of the block: a host span, timed on the card by a
    pair of events on the current stream when `device` is a card (kept by
    a graph that captures it).  Yields an object whose enter(*inputs) and
    exit(outputs) mark the block's differentiable inputs and outputs for
    its backward phase.  No-op with tracing off."""
    if not _tracing:
        return _NULL
    return _PhaseCM(name, device, attrs)


class GraphTrace:
    """The device phases a CUDA-graph capture recorded; each replay's
    times are read once the replay has run."""

    def __init__(self):
        self.batches = []
        self.pending = None  # (call, parent span id) of the unread replay

    def replay(self, graph):
        """Replays `graph`, reading this trace's previous replay first (a
        no-op where the caller has read it already)."""
        self.read()
        graph.replay()
        parent = _open[-1] if _open else None
        self.pending = ((parent.call, parent.id) if parent is not None
                        else (next(_calls), None))
        _replayed.add(self)

    def read(self):
        if self.pending is None:
            return
        call, parent = self.pending
        self.pending = None
        for b in self.batches:
            _read(b, call, parent)


@contextlib.contextmanager
def capture():
    """The device phases recorded inside go to the GraphTrace it yields
    (the graph's), not to the eager reads."""
    global _sink, _batch
    saved = (_sink, _batch)
    _sink, _batch = GraphTrace(), None
    try:
        yield _sink
    finally:
        _sink, _batch = saved


def _wait(ev):
    if not ev.query():
        ev.synchronize()


def _read(batch, call=None, parent=None):
    """The device seconds of a batch's phases: on its own records (an eager
    batch, call None), or on new records of a replay's call under
    `parent`; then the whole-body phases' `.other`, the backward phases
    and `autograd.other`."""
    _wait(batch.last_event())
    recs = {}  # template span id -> its record of this read
    for s, e0, e1 in batch.phases:
        dt = e0.elapsed_time(e1) * 1e-3
        if call is None:
            s.device, r = dt, s
        else:
            r = Span(call, next(_ids), s.parent, s.name, None, None,
                     s.attrs, dt)
            _records.append(r)
        recs[s.id] = r
    if call is not None:
        for r in recs.values():
            r.parent = recs[r.parent].id if r.parent in recs else parent
    by_id = {r.id: r for r in recs.values()}
    inner = {}
    for r in recs.values():
        if r.parent in by_id:
            inner[r.parent] = inner.get(r.parent, 0.0) + r.device
    for r in recs.values():
        if r.name in WHOLE_BODY:
            _records.append(Span(r.call, next(_ids), r.id, r.name + ".other",
                                 None, None, {}, r.device - inner.get(r.id,
                                                                      0.0)))
    events = {s.id: (e0, e1) for s, e0, e1 in batch.phases}
    by_autograd = {}
    for m in batch.marks:
        by_autograd.setdefault(m[4], []).append(m)
    for aid, marks in by_autograd.items():
        _split_backward(marks, events.get(aid), recs.get(aid), call)


def _split_backward(marks, events, autograd, call):
    """bwd:<phase> records of an autograd phase's marks: each stretch
    between two marks (and before the first, after the last) goes to the
    backward phase a start mark opened and no end mark closed yet, else
    to `autograd.other`."""
    if events is None or autograd is None:
        return
    e0, e1 = events
    total = e0.elapsed_time(e1) * 1e-3
    cur, t_prev, other = None, 0.0, 0.0
    inst = {}  # key -> [rec, seconds, host start, host end]
    for kind, rec, ev, host_t, _ in marks:
        t = e0.elapsed_time(ev) * 1e-3
        if cur is None:
            other += t - t_prev
        else:
            inst[cur][1] += t - t_prev
        if kind == "start":
            cur = rec.key
            inst.setdefault(rec.key, [rec, 0.0, host_t, host_t])
        elif cur == rec.key:
            cur = None
        if rec.key in inst:
            inst[rec.key][3] = host_t
        t_prev = t
    if cur is None:
        other += total - t_prev
    else:
        inst[cur][1] += total - t_prev
    eager = call is None
    for rec, sec, h0, h1 in inst.values():
        _records.append(Span(autograd.call, next(_ids), autograd.id,
                             "bwd:" + rec.name, h0 if eager else None,
                             h1 if eager else None, rec.attrs, sec))
    _records.append(Span(autograd.call, next(_ids), autograd.id,
                         "autograd.other", None, None, {}, other))


def _flush(wait):
    """Reads the finished device phases: every one (waiting for the card)
    when `wait`, else the eager batches the card has finished."""
    global _pending, _replayed
    if wait:
        for t in _replayed:
            t.read()
        _replayed = set()
    keep = []
    for b in _pending:
        if wait or b.last_event().query():
            _read(b)
        else:
            keep.append(b)
    _pending = keep


def records(clear=False):
    """Every record so far, the device phases read (waiting for the card);
    clear: start a new list."""
    global _records
    _flush(True)
    out = list(_records)
    if clear:
        _records = []
    return out


def clear():
    """Drops the records and the unread device phases."""
    global _records, _pending, _replayed
    _records, _pending, _replayed = [], [], set()
    _loose.clear()


class _Timed:
    __slots__ = ("label", "sync", "cm", "t0")

    def __init__(self, label):
        self.label = label

    def __enter__(self):
        self.sync = None
        if _print_timing:
            self.sync = (torch.cuda.synchronize if use_gpu()
                         else (lambda: None))
            self.sync()
        self.cm = _SpanCM(self.label, {}) if _tracing else None
        if self.cm is not None:
            self.cm.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            self.sync()
        t1 = time.perf_counter()
        if self.cm is not None:
            self.cm.__exit__(*exc)
        if self.sync is not None:
            print(f"{self.label}: {(t1 - self.t0) * 1e3:.2f} ms", flush=True)
        return False


def timed(label: str):
    """A span of the block that prints its wall time when
    set_print_timing(True).  Printing, both clock reads follow a
    torch.cuda.synchronize() on the card, so the time is the work's and
    not the launches'."""
    if not (_print_timing or _tracing):
        return _NULL
    return _Timed(label)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler trace of the block (host ops, and the card's kernels
    when there is one), written to log_dir as a Chrome trace JSON file,
    with tracing on inside (the port's spans appear in it by name).
    Yields the profiler, whose key_averages() tabulate the same events."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    saved = _tracing
    set_tracing(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        set_tracing(saved)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
