"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout.  The cell, its configuration, its traffic
mix and its metrics are found by name: BENCHMARK.json names them, and
each lives in files of its own under portbench/ (configs/<config>.json
and the module beside it, configs/<config>.py, which builds the scene of
both sides (load_config); traffic/<traffic>.json,
layer_metrics/<metric>.py, limits/<cell>.json).

The run builds the loop in set-up (its first calls compile and capture),
measures for --seconds, reads the per-layer metrics with --trace 1, then
frees the port's state and checks the set-up's checked calls (gradient
cells) or the window's checked frames (frame cells) against the plain
reference under portbench/reference.  The last line of standard output
is one JSON object; the compared numbers and their limits end standard
error.  A run without enough CUDA devices, or whose process holds JAX or
the JAX package at the end, prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
# Every build and kernel cache inside the checkout, at fixed paths.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(CACHE / _sub)
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "4")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Top-level module names no run may hold: JAX and the JAX package (and
# redner_torch, whose compute core is JAX).  Compared whole, so the port,
# redner_tpu_torch, is not one of them.
FORBIDDEN = ("jax", "jaxlib", "flax", "redner_tpu", "redner_torch")


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def load_bench(root):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _json(root, sub, name):
    return json.loads((Path(root) / "portbench" / sub /
                       f"{name}.json").read_text())


def _load_module(path, prefix, name):
    """The module at `path`, loaded by path under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def load_reader(root, name):
    """layer_metrics/<name>.py's read(ctx)."""
    return _load_module(Path(root) / "portbench" / "layer_metrics" /
                        f"{name}.py", "portbench_metric_", name).read


def load_config(root, name):
    """Configuration `name` of BENCHMARK.json: (its sizes, the JSON file
    that BENCHMARK.json names, and its module, configs/<name>.py).  The
    module owns all that depends on the shape of the scene:

      build_scene(api, cfg, resolution, device)  the port's scene, through
          its user API (resolution: (height, width))
      build_reference(cfg, resolution, device)  the reference's scene
      LEAVES, REFERENCE_LEAVES  {leaf: where it lives in a port scene and
          in a reference scene, as a function of the scene that returns
          the tensor, or None for a leaf that lives outside the scene and
          that posed / posed_reference apply}
      perturbed(traffic, seed)  the start of each leaf the traffic names,
          drawn from the seed: {leaf: (how, float array)}, how "set",
          "shift" or "scale" (loops.apply_start)
      posed(scene, leaves), posed_reference(scene, leaves)  the scene to
          render at the leaves, [(leaf, tensor)]
      render_reference(scene, num_samples, seed, bounces)  the reference's
          (height, width, 3) image; run under check.precision(mode),
          whose "tf32" rounds reference/plain.py's ray-triangle products
      move_reference_camera(scene, position)  a frame cell's camera move
          on the reference's scene, in place
      EDGES  None, or the reference's edge terms: a module with
          topology(scene) and surrogate(scene, adj, num_samples, seed,
          bounces, primary, secondary, topology), as reference/edges.py
      tiny(cfg)  optional: the sizes shrunk for a CPU test

    Every input array is made by the module from the JSON, once for each
    side: nothing built by one side is handed to the other."""
    entry = next(c for c in load_bench(root)["configs"] if c["name"] == name)
    cfg = json.loads((Path(root) / entry["file"]).read_text())
    return cfg, _load_module(Path(root) / "portbench" / "configs" /
                             f"{name}.py", "portbench_config_", name)


def _applies(metric, cell, e2e_names):
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    return metric["moves"] in e2e_names


def run_cell(root, workload, seed, seconds, trace, device="cuda",
             t_start=None):
    """One run of a cell.  Returns (result dict, [(name, value, limit)],
    {name: value} of every number read)."""
    import torch

    import redner_tpu_torch as rtt
    from portbench import loops, trace as tr, yardstick as ys
    from portbench.reference import check

    t_start = T_START if t_start is None else t_start
    loops.T0 = t_start
    bench = load_bench(root)
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg, conf = load_config(root, cell["config"])
    traffic = _json(root, "traffic", cell["traffic"])
    limits = _json(root, "limits", workload)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    loops.note("imports done")

    def make_loop(spans):
        return loops.MAKERS[traffic["kind"]](rtt, cfg, conf, traffic, seed,
                                             dev, spans)

    spans = loops.Spans(False)
    loop = make_loop(spans)
    if on_card:
        torch.cuda.synchronize(dev)
    before = tr.graph_counters()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    print(f"[setup] {setup_s:.3f} s", file=sys.stderr)
    window_s, count, lat = loops.run_window(loop, seconds)
    print(f"[window] {count} in {window_s:.3f} s", file=sys.stderr)
    after = tr.graph_counters()
    mem = torch.cuda.max_memory_reserved(dev) if on_card else 0

    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    values = {"setup_s": setup_s, "peak_mem_mib": mem / 2**20}
    if traffic["kind"] == "grad":
        values["grad_step_ms"] = window_s * 1e3 / count
    else:
        values["frame_ms"] = window_s * 1e3 / count
        values["frame_p95_ms"] = ys.p95(lat) * 1e3
    device_out = {"platform": "gpu" if on_card else dev.type,
                  "kind": (torch.cuda.get_device_name(dev) if on_card
                           else "cpu"),
                  "count": 1, "memory_peak_bytes": int(mem)}
    result = {"correct": False, "attempted": count, "failed": 0}

    if trace:
        ctx = _trace_context(loop, conf, make_loop, traffic, before, after,
                             count, window_s, spans, dev, on_card)
        metrics = {}
        for m in bench["per_layer"]:
            if not _applies(m, cell, e2e_names):
                continue
            v = load_reader(root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if ctx.profile is not None:
            device_out["busy_s"] = ctx.busy_s
            device_out["window_s"] = ctx.window_s
            result["breakdown"] = {"device_ops": ctx.top_ops,
                                   "idle_gaps": ctx.idle_gaps}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e}

    # The check: the port's state is freed first, so the reference sets
    # no peak and has the card to itself.
    prog_check = loop.check
    del loop
    gc.collect()
    if on_card:
        from redner_tpu_torch import graphs
        graphs.clear()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    if traffic["kind"] == "grad":
        refr = check.grad_readings(cfg, conf, traffic, seed, dev,
                                   states=prog_check["states"])
        numbers = check.compare_grad(prog_check, refr)
        if any(x != x for x in prog_check["losses"]):
            result["failed"] = 1
    else:
        frames = prog_check["frames"]
        numbers = {}
        if frames:
            refr = check.frame_reference(cfg, conf, traffic, seed,
                                         sorted(frames), dev)
            numbers = check.compare_frames(frames, refr)
        print(f"[check] {len(frames)} of the drawn frames were rendered "
              f"in the window: {sorted(frames)}", file=sys.stderr)
    print(f"[check] the reference took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    for k in sorted(set(numbers) - set(limits)):
        print(f"[check] {k} = {numbers[k]!r} (read, not compared)",
              file=sys.stderr)
    compared = [(k, float(numbers[k]), float(lim))
                for k, lim in limits.items()] if numbers else []
    # A frame cell whose window reached none of the drawn frames has
    # nothing compared, and is not correct.
    result["correct"] = bool(numbers) and all(v <= lim
                                              for _, v, lim in compared)
    result["metrics"] = metrics
    result["device"] = device_out
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in compared}
    return result, compared, numbers


def _trace_context(loop, conf, make_loop, traffic, before, after, count,
                   window_s, spans, dev, on_card):
    """What the per-layer readers read: the window's counters and its
    seconds per step or frame (untraced), a profile of a steady stretch,
    the work bounds of one eager call's ray queries beside their kernels'
    time, and the run's make_loop(spans) with its device, from which
    program_trace builds the loop of its traced stretch."""
    from types import SimpleNamespace

    import torch

    import redner_tpu_torch as rtt
    from portbench import trace as tr

    ctx = SimpleNamespace(kind=traffic["kind"], window_count=count,
                          step_s=window_s / count,
                          before=before, after=after, profile=None,
                          launches=[], span_log=[], make_loop=make_loop,
                          device=dev)
    if not on_card:
        return ctx
    n = traffic["profiled_steps" if loop.kind == "grad" else
                "profiled_frames"]
    prof = tr.profile_stretch(loop, n, spans, dev)
    if prof is not None:
        kern, h0, wall, log = prof
        busy, top, gaps = tr.summarise(kern, wall, log, h0)
        ctx.profile, ctx.profiled = kern, n
        ctx.busy_s, ctx.window_s = busy, wall
        ctx.top_ops, ctx.idle_gaps, ctx.span_log = top, gaps, log
    if loop.kind == "grad":
        def call():
            img = rtt.render(conf.posed(loop.scene, loop.leaves), loop.opts,
                             seed=loop.next_k)
            torch.mean((img - loop.target) ** 2).backward()
            loop.opt.zero_grad()
    else:
        def call():
            with torch.no_grad():
                rtt.render_image(loop.scene, loop.opts, seed=loop.next_k)
    ctx.launches = tr.eager_launches(call, dev)
    for kind, bound_s, by, tests, kt in ctx.launches:
        print(f"[roofline] {kind}: {tests} tests, bound {bound_s * 1e3:.4f} "
              f"ms by {by}, kernel "
              f"{'not measured' if kt is None else f'{kt * 1e3:.4f} ms'}",
              file=sys.stderr)
    return ctx


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_bench(ROOT)
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from portbench.yardstick import device_line
    print(f"[device] {device_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", file=sys.stderr)
    result, compared, _ = run_cell(ROOT, args.workload, args.seed,
                                args.seconds, args.trace)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v, lim in compared:
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
