"""The graph cache bounded by the device memory its graphs keep
(redner_tpu_torch.graphs), on the CPU: the card's memory queries, the
measured eager runs and the captures are replaced by fakes that keep the
bytes a capture would reserve and run out of memory where a card would,
so the eviction and route rules run as they do on a card."""

import weakref

import pytest
import torch

from redner_tpu_torch import graphs
from tests.torch_port_spawn import single_triangle
from tests.torch_port_util import two_torch_threads  # noqa: F401

TOTAL = 100  # bytes of the fake card


class FakeCard:
    """Free memory = TOTAL - the bytes of every live fake graph.  An eager
    run of a body needs `peak[(key, kind)]` (else `peak[kind]`) bytes and
    a capture CAPTURE_MARGIN x that; either raises where the card has
    less free.  A capture records without running the body; a replay
    runs it (a graph's collectives run at its replays only).  runs counts
    the bodies' runs, eager or replayed."""

    def __init__(self, monkeypatch):
        self.live = weakref.WeakSet()
        self.peak = {"forward": 10, "backward": 40}
        self.runs = 0
        card = self

        def need(body):
            prog = body.__self__
            kind = body.__name__.lstrip("_")
            return card.peak.get((prog.scene.camera.resolution[0], kind),
                                 card.peak[kind])

        def run(body, size):
            if card.free() < size:
                raise torch.cuda.OutOfMemoryError(
                    f"fake card: {size} bytes asked, {card.free()} free")
            card.runs += 1
            return body()

        class Graph:
            def __init__(self, kind, body, device):
                self.kind, self.body = kind, body  # as a card's graph
                # holds its program
                self.bytes = graphs.CAPTURE_MARGIN * need(body)
                if card.free() < self.bytes:
                    raise torch.cuda.OutOfMemoryError("fake card: capture")
                self.out = None
                card.live.add(self)
                graphs.CAPTURES[kind] += 1

            def replay(self):
                self.out = run(self.body, 0)
                graphs.REPLAYS[self.kind] += 1

        monkeypatch.setattr(graphs, "_Graph", Graph)
        monkeypatch.setattr(graphs, "_measured", lambda body, device: (
            run(body, need(body)), need(body)))
        monkeypatch.setattr(graphs, "_device_free",
                            lambda device, need=None: card.free())

    def free(self):
        return TOTAL - sum(g.bytes for g in self.live)


@pytest.fixture
def card(monkeypatch):
    graphs.clear()
    yield FakeCard(monkeypatch)
    graphs.clear()


def _program(tag, backward=False):
    """The cached Program of key `tag` (its own scene resolution), with
    bodies that return the sum of the vertices (and its gradient)."""
    scene = single_triangle(res=(tag, tag))

    def forward(s, seed):
        return s.shapes[0].vertices.sum() + seed

    def backward_body(s, seed, ct):
        return tuple(torch.ones_like(t) if t.is_floating_point() else None
                     for t in graphs.scene_tensors(s))

    return graphs.program(
        "render", scene, _options(), True, None,
        lambda sc: graphs.Program(sc, forward,
                                  backward_body if backward else None)), scene


def _options():
    import redner_tpu_torch as rtt

    return rtt.RenderOptions(num_samples=1, max_bounces=1)


def _call(prog, scene, kind="forward"):
    tensors = graphs.scene_tensors(scene)
    seed = torch.zeros((), dtype=torch.int64)
    if kind == "forward":
        return prog.forward(tensors, seed)
    return prog.backward(tensors, seed, torch.zeros(()))


def _use(tag, *kinds, backward=False):
    """Calls of key `tag` (a forward, or the kinds given), keeping no
    reference to its program."""
    prog, scene = _program(tag, backward=backward or "backward" in kinds)
    for kind in kinds or ("forward",):
        _call(prog, scene, kind)


def _held():
    """The resolutions of the cached keys that hold a graph, least recent
    first."""
    return [prog.scene.camera.resolution[0]
            for prog in graphs._cache.values() if prog.bytes]


def test_eviction_follows_the_bytes_least_recent_first(card):
    """Programs of 42 bytes on a 100-byte card: two fit; a third's capture
    releases the least recently used one's graph, and a call makes a key
    recent.  Each key's first call runs eagerly, the second captures."""
    card.peak["forward"] = 40
    for tag in (4, 5, 6):
        _use(tag)  # measured, nothing captured
    assert _held() == [] and graphs.cached_bytes() == dict.fromkeys(
        graphs._cache, 0)
    _use(4)
    _use(5)
    assert _held() == [4, 5]
    assert all(v == pytest.approx(42.0) for v in graphs.cached_bytes().values()
               if v)
    _use(6)  # 16 bytes free: 4 goes
    assert _held() == [5, 6]
    _use(5)  # a replay makes it the most recent
    _use(4)
    assert _held() == [5, 4] and len(card.live) == 2
    assert len(graphs._cache) == 3  # a released key keeps its measurements


def test_an_evicted_program_held_elsewhere_stays_valid(card):
    """A program whose graph is released while something (an autograd
    ctx) holds it stays valid: its next call captures again, from its
    kept measurement, and replays."""
    held, scene = _program(4)
    _call(held, scene)
    _call(held, scene)
    assert held.graphs["forward"] is not None
    _use(5)  # a first call, not measured yet: every other graph goes
    assert held.graphs["forward"] is None
    captures, replays = graphs.CAPTURES["forward"], graphs.REPLAYS["forward"]
    assert float(_call(held, scene)) == float(scene.shapes[0].vertices.sum())
    assert graphs.CAPTURES["forward"] == captures + 1
    assert graphs.REPLAYS["forward"] == replays + 1


def test_a_key_that_does_not_fit_runs_eagerly(card):
    """A key whose measured need x CAPTURE_MARGIN exceeds what an empty
    card holds runs eagerly from its second call on (EAGER["memory"]),
    and every eager call first makes room for its need, releasing the
    graphs that another key captured in between."""
    _use(4)
    _use(4)
    card.peak[(5, "forward")] = 99
    big, sbig = _program(5)
    eager = graphs.EAGER["memory"]
    _call(big, sbig)  # measured: 99
    assert not big.eager and graphs.EAGER["memory"] == eager
    _use(4)  # captures again beside nothing
    assert _held() == [4]
    out = _call(big, sbig)  # 103.95 cannot fit: eager
    assert float(out) == float(sbig.shapes[0].vertices.sum())
    assert big.eager and big.bytes == 0
    assert graphs.EAGER["memory"] == eager + 1
    _use(4)
    assert _held() == [4]
    _call(big, sbig)  # room for 99: 4's graph goes
    assert _held() == [] and graphs.EAGER["memory"] == eager + 2


def test_a_first_backward_releases_every_other_graph(card):
    """A backward not measured yet releases every other program's graphs
    and the key's own forward graph before it runs; the forward then
    captures again with room for both graphs, and the backward captures
    beside it."""
    _use(4)
    _use(4)
    prog, s = _program(5, backward=True)
    _call(prog, s)
    _use(4)
    _call(prog, s)
    assert sorted(_held()) == [4, 5]
    _call(prog, s, "backward")  # not measured: everything goes
    assert _held() == [] and prog.graphs["forward"] is None
    _call(prog, s)  # captures with room for 1.05 x (10 + 40)
    _call(prog, s, "backward")
    assert prog.graphs["backward"] is not None and not prog.eager
    assert prog.bytes == pytest.approx(graphs.CAPTURE_MARGIN * 50)


def test_a_large_eager_gradient_after_a_cached_one_makes_room(card):
    """A gradient key that fits (about 16 spp at 1024x1024 on an 80 GB
    card: 1 + 52 of 100 bytes) captured, then one that cannot (32 spp:
    1 + 98), with no clear() between them, in both orders: the large
    key's eager runs release the cached graphs first, and nothing runs
    out of memory."""
    small, big = 6, 7
    card.peak.update({(small, "forward"): 1, (small, "backward"): 52,
                      (big, "forward"): 1, (big, "backward"): 98})
    for _ in range(2):
        _use(small, "forward", "backward")
    assert _held() == [small]
    for _ in range(2):
        _use(big, "forward", "backward")
    prog, _ = _program(big, backward=True)
    assert prog.eager and _held() == []
    for _ in range(2):
        _use(small, "forward", "backward")  # captures again
    assert _held() == [small]
    eager = graphs.EAGER["memory"]
    _use(big, "forward", "backward")  # room for 98: small's graphs go
    assert graphs.EAGER["memory"] == eager + 2 and _held() == []


@pytest.mark.parametrize("backward", [False, True])
def test_every_call_runs_the_body_once(card, backward):
    """Whatever route a call takes (the first, eager run; the capture and
    its replay; a replay; a call after its graphs were released; an eager
    call of a key that does not fit), the body runs once: under a pixel
    sharding the ranks then issue the same collectives whatever each
    one's free memory chose."""
    kind = "backward" if backward else "forward"
    prog, s = _program(4, backward=backward)

    def once():
        runs = card.runs
        if backward:
            _call(prog, s)
            runs = card.runs
        _call(prog, s, kind)
        assert card.runs == runs + 1

    for _ in range(3):
        once()
    assert prog.graphs[kind] is not None
    _use(5)  # not measured yet: 4's graphs go
    once()
    card.peak[(4, kind)] = 99
    prog.needs[kind] = 99  # as if measured: no longer fits
    prog.graphs = dict.fromkeys(graphs.KINDS)
    once()
    assert prog.eager
    once()


class StubMemory:
    """torch.cuda's memory readings of one card, in bytes: `free` on the
    card, `reserved` by the allocator, `allocated` of it, `split` the free
    parts of partly used segments; empty_cache() returns the other unused
    bytes to the card and is counted in `flushes`."""

    def __init__(self, monkeypatch, free, reserved, allocated, split):
        self.free, self.reserved = free, reserved
        self.allocated, self.split = allocated, split
        self.flushes = 0
        stub = self
        for name, fn in (
                ("mem_get_info", lambda device=None: (stub.free, 10 ** 6)),
                ("memory_reserved", lambda device=None: stub.reserved),
                ("memory_allocated", lambda device=None: stub.allocated),
                ("memory_stats", lambda device=None: {
                    "inactive_split_bytes.all.current": stub.split}),
                ("empty_cache", stub.empty_cache)):
            monkeypatch.setattr(torch.cuda, name, fn)

    def empty_cache(self):
        self.flushes += 1
        back = self.reserved - self.allocated - self.split
        self.free += back
        self.reserved -= back


@pytest.fixture
def empty_cache_of_programs():
    graphs.clear()
    yield
    graphs.clear()


def test_eager_runs_count_the_allocators_unused_blocks(
        monkeypatch, empty_cache_of_programs):
    """Free for an eager run = the card's free bytes + the allocator's
    unused ones (reserved - allocated - split): 10 + (50 - 20 - 5) = 35.
    The cache is emptied only for a need they do not cover, or a need not
    measured yet (a capture's pool takes the card's own free memory)."""
    mem = StubMemory(monkeypatch, free=10, reserved=50, allocated=20,
                     split=5)
    assert graphs._device_free("cuda", need=35) == 35
    assert mem.flushes == 0
    assert graphs._device_free("cuda", need=36) == 35
    assert mem.flushes == 1 and (mem.free, mem.reserved) == (35, 25)
    mem.reserved += 25  # the next run left 25 unused bytes cached again
    mem.free -= 25
    assert graphs._device_free("cuda") == 35
    assert mem.flushes == 2


def test_unused_blocks_of_graph_pools_do_not_count(
        monkeypatch, empty_cache_of_programs):
    """A cached program's pool keeps its free blocks for its graphs: its
    bytes come off the unused count."""
    mem = StubMemory(monkeypatch, free=10, reserved=50, allocated=20,
                     split=0)
    prog, _ = _program(4)
    prog.device = "cuda"  # the stubbed card's

    class Held:
        bytes = 18

    prog.graphs["forward"] = Held()
    assert graphs._unused("cuda") == 50 - 20 - 18
    assert graphs._device_free("cuda", need=22) == 22
    assert mem.flushes == 0
    prog.graphs["forward"] = None
    assert graphs._unused("cuda") == 30


def test_only_a_first_eager_run_empties_the_cache(
        monkeypatch, empty_cache_of_programs):
    """Program.run_eagerly: the first run of a kind (need not measured)
    empties the cache and measures 20 bytes; the next runs find them
    among the unused blocks and leave the cache as it is.  A capture
    still empties it first."""
    mem = StubMemory(monkeypatch, free=30, reserved=0, allocated=0,
                     split=0)
    prog, _ = _program(4)

    def body():  # a run that reserves 20 bytes and leaves them cached
        if mem.reserved < 20:
            mem.free -= 20 - mem.reserved
            mem.reserved = 20
        return 1

    for _ in range(3):
        assert prog.run_eagerly("create_graph", body) == 1
    assert prog.needs["create_graph"] == 20
    assert mem.flushes == 1
    assert graphs._make_room(5, prog)  # as before a capture
    assert mem.flushes == 2
