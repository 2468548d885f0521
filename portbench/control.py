"""The readings that a cell's limits are set from: the port's, the
control's and the planted faults', each against the plain reference, on
many seeds in one process.  Not run by the benchmark's own runs.

    python3 portbench/control.py --workload <name> --seeds 1,2,3
        --side program|control|fault:<name> [--seconds S]

  program    a run of the cell (run.run_cell) with a window of --seconds
             (default: the cell's run_seconds)
  control    the reference in the port's place, its ray-triangle products
             rounded to TF32: the step below the float32 with TF32 off
             that the configuration states
  fault:*    a run of the cell with a fault planted under the harness
             (FAULTS; the edge faults where the cell's traffic turns the
             sampler on, `applies`)

Prints one JSON line per seed with every number read.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FAULTS = ("frozen_state", "half_samples", "altered_answer", "stale_replay",
          "no_primary_edge", "no_secondary_edge", "half_edges",
          "flipped_edges")
# The edge faults scale the port's edge surrogates where they are made:
# the primary one in render_grad's backward, the secondary one at each
# bounce of the re-render (redner_tpu_torch.render._secondary_edge_term).
EDGE_FAULTS = {"no_primary_edge": (0.0, 1.0), "no_secondary_edge": (1.0, 0.0),
               "half_edges": (0.5, 0.5), "flipped_edges": (-1.0, -1.0)}


def applies(fault, traffic):
    """Whether `fault` is one the traffic's cell can have: an edge fault
    needs the sampler it breaks turned on."""
    if fault not in EDGE_FAULTS:
        return True
    prim, sec = EDGE_FAULTS[fault]
    return ((prim != 1.0 and traffic.get("primary_edge", False))
            or (sec != 1.0 and traffic.get("secondary_edge", False)))


def _scaled(f, by):
    return lambda *a, **k: by * f(*a, **k)


def _half_samples(opts):
    return opts._copy_with(num_samples=opts.num_samples // 2,
                           num_samples_backward=opts.num_samples // 2)


# The unit the port produces its image in: a block of swizzled lanes
# (redner_tpu_torch.render.SWIZZLE_BLOCK), 16 rows by 32 columns.
ALTERED_BLOCK = (16, 32)


def _altered(img):
    """The image with one block of pixels altered (+1) where it is
    produced.  A change of fewer pixels lies within the hit flips that
    two independent float32 intersection tests part on (PERF.md)."""
    bump = img.new_zeros(img.shape)
    bump[:ALTERED_BLOCK[0], :ALTERED_BLOCK[1]] = 1.0
    return img + bump


def _stale_graphs(graphs, torch):
    """Replays that keep the inputs of their capture: Program.forward and
    .backward copy the call's scene tensors and seed into the graph's
    static inputs only while the graph is not yet captured."""
    P = graphs.Program

    def forward(self, tensors, seed):
        if self.graphs["forward"] is None:
            self._load(tensors, seed)
        return self._run("forward")

    def backward(self, tensors, seed, ct):
        if self.graphs["backward"] is None:
            self._load(tensors, seed)
        if self.ct is None:
            self.ct = torch.empty_like(ct)
        with torch.no_grad():
            self.ct.copy_(ct)
        return self._run("backward")

    return [(P, "forward", forward), (P, "backward", backward)]


def _stale_entry(f, scene_tensors, scene_with_tensors):
    """The same fault where no graph replays (a CPU run): from the third
    call on, the entry renders the scene tensors and seed of its second
    call (the capture), with the current leaves' gradients passed through
    at those stale values."""
    kept = {}

    def stale(scene, opts, seed=0, **kw):
        kept["n"] = kept.get("n", 0) + 1
        ts = scene_tensors(scene)
        if kept["n"] == 2:
            kept["inputs"] = ([t.detach().clone() for t in ts], seed)
        if kept["n"] <= 2:
            return f(scene, opts, seed=seed, **kw)
        old, old_seed = kept["inputs"]
        ts = [o + (t - t.detach()) if t.requires_grad else o
              for o, t in zip(old, ts)]
        return f(scene_with_tensors(scene, ts), opts, seed=old_seed, **kw)
    return stale


def plant(fault, rtt, torch, kind, device="cuda"):
    """Plant `fault` in the entry point that the window of a `kind` loop
    drives (`render` for "grad", `render_image` for "frame"), in its
    training step, in the graph cache under them, or in the edge
    surrogates of its backward; returns an undo."""
    from redner_tpu_torch import graphs
    from redner_tpu_torch.scene import scene_tensors, scene_with_tensors

    # The modules, which the package's functions of the same name hide.
    render_mod = importlib.import_module("redner_tpu_torch.render")
    render_grad = importlib.import_module("redner_tpu_torch.render_grad")

    entry = "render" if kind == "grad" else "render_image"
    f = getattr(rtt, entry)
    saved = [(rtt, entry, f), (torch.optim.Adam, "step",
                               torch.optim.Adam.step),
             (graphs.Program, "forward", graphs.Program.forward),
             (graphs.Program, "backward", graphs.Program.backward),
             (render_grad, "primary_edge_gradients",
              render_grad.primary_edge_gradients),
             (render_mod, "_secondary_edge_term",
              render_mod._secondary_edge_term)]
    if fault in EDGE_FAULTS:
        prim, sec = EDGE_FAULTS[fault]
        render_grad.primary_edge_gradients = _scaled(
            render_grad.primary_edge_gradients, prim)
        render_mod._secondary_edge_term = _scaled(
            render_mod._secondary_edge_term, sec)
    elif fault == "frozen_state":  # the step returns its state unchanged
        if kind == "grad":
            torch.optim.Adam.step = lambda self, closure=None: None
        else:
            first = {}

            def frozen(scene, opts, seed=0, **kw):
                if "img" not in first:
                    first["img"] = f(scene, opts, seed=seed, **kw)
                return first["img"].clone()
            setattr(rtt, entry, frozen)
    elif fault == "half_samples":  # half the samples, the mean of the rest
        setattr(rtt, entry, lambda s, o, seed=0, **kw: f(
            s, _half_samples(o), seed=seed, **kw))
    elif fault == "altered_answer":
        setattr(rtt, entry, lambda s, o, seed=0, **kw: _altered(
            f(s, o, seed=seed, **kw)))
    elif fault == "stale_replay":
        if torch.device(device).type == "cuda":
            for obj, name, val in _stale_graphs(graphs, torch):
                setattr(obj, name, val)
        else:
            setattr(rtt, entry, _stale_entry(f, scene_tensors,
                                             scene_with_tensors))
    else:
        raise ValueError(f"unknown fault {fault!r}")

    def undo():
        for obj, name, val in saved:
            setattr(obj, name, val)
    return undo


def readings(root, workload, seed, side, seconds, device="cuda"):
    """Every number read on one seed on one side: {name: value}."""
    import torch

    import redner_tpu_torch as rtt
    from portbench import loops, run
    from portbench.reference import check

    cell = next(w for w in run.load_bench(root)["workloads"]
                if w["name"] == workload)
    traffic = run._json(root, "traffic", cell["traffic"])
    if side != "control":
        undo = (plant(side.split(":", 1)[1], rtt, torch, traffic["kind"],
                      device)
                if side.startswith("fault:") else (lambda: None))
        try:
            numbers = run.run_cell(root, workload, seed, seconds, 0,
                                   device=device)[2]
        finally:
            undo()
        return numbers
    cfg, conf = run.load_config(root, cell["config"])
    dev = torch.device(device)
    if traffic["kind"] == "grad":
        prog = check.grad_readings(cfg, conf, traffic, seed, dev,
                                   mode="tf32")
        return check.compare_grad(prog, check.grad_readings(
            cfg, conf, traffic, seed, dev, states=prog.get("states")))
    ks = loops.checked_frames(traffic, seed, traffic["warm_frames"])
    prog = check.frame_reference(cfg, conf, traffic, seed, ks, dev,
                                 mode="tf32")
    return check.compare_frames(prog, check.frame_reference(
        cfg, conf, traffic, seed, ks, dev))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--side", default="program")
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    from portbench.run import load_bench

    seconds = args.seconds or load_bench(ROOT)["run_seconds"]
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        numbers = readings(ROOT, args.workload, int(s), args.side, seconds)
        print(json.dumps({"workload": args.workload, "side": args.side,
                          "seed": int(s), "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
