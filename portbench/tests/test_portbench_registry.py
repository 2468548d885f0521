"""A configuration, a traffic mix and a per-layer metric are found by
name: a new cell made only of new files and new entries runs through the
harness on the CPU, down to the plain reference, and no file that was
there changes."""

import hashlib
import json

from portbench.tests.tiny import run_cpu, tiny_root


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_cell_runs_from_new_files_only(tmp_path):
    root = tiny_root(tmp_path)
    before = _digests(root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs/pose_sphere15k.json").read_text())
    cfg.update(name="dim_sphere", light=dict(cfg["light"],
                                             intensity=[5.0, 5.0, 5.0]))
    (pb / "configs/dim_sphere.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic/fwd512.json").read_text())
    traffic.update(resolution=[8, 8], num_samples=1)
    (pb / "traffic/fwd8.json").write_text(json.dumps(traffic))
    (pb / "limits/dim.fwd8.json").write_text(json.dumps(
        {"frame_l1_gap": 1e-6, "frame_px_off": 1e-6}))
    (pb / "layer_metrics/window_frames.py").write_text(
        "def read(ctx):\n    return ctx.window_count\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dim_sphere", "source": "test",
                             "file": "portbench/configs/dim_sphere.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dim.fwd8", "config": "dim_sphere",
                               "traffic": "fwd8", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:  # the frame metrics take the new cell
        if m["name"] in ("frame_ms", "frame_p95_ms"):
            m["workloads"].append("dim.fwd8")
    bench["per_layer"].append({"name": "window_frames", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "frame_ms",
                               "workloads": ["dim.fwd8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    result = run_cpu(root, "dim.fwd8", trace=1)
    assert result["correct"] is True
    assert result["metrics"]["window_frames"]["value"] == result["attempted"]
    assert set(result["checks"]) == {"frame_l1_gap", "frame_px_off"}
    result = run_cpu(root, "dim.fwd8", trace=0)
    assert set(result["metrics"]) == {"setup_s", "frame_ms", "frame_p95_ms",
                                      "peak_mem_mib"}
    after = _digests(root)
    changed = [p for p in before if before[p] != after.get(p)]
    assert changed == [root / "BENCHMARK.json"]
