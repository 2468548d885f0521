"""A configuration, a traffic mix and a per-layer metric are found by
name: a new cell made only of new files and new entries runs through the
harness on the CPU, down to the plain reference, and no file that was
there changes.  So does a configuration of a scene of another shape,
which brings its own module (scene, leaves and reference)."""

import hashlib
import json
import shutil

import pytest
import torch

import redner_tpu_torch as rtt
from portbench import control
from portbench.tests.tiny import REPO, run_cpu, tiny_root


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
    (pb / "configs/dim_sphere.py").write_text(
        (pb / "configs/pose_sphere15k.py").read_text())
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


# A diffuse quad under a quad light (portbench/tests/quad_lit, laid out as
# under portbench/): its module, sizes, two traffic mixes at 8x8 and their
# limits.  The limits lie between sound CPU runs (image and frame gaps
# under 6e-8, no pixel off, change gap 0, over 3 seeds) and half_samples
# (image 0.23, grad 0.037, change median 8.9e-4, frame 0.20 and 36% of
# pixels off, at the least).
QUAD_CELLS = {"quad.grad": ("quad_grad", "grad_step_ms"),
              "quad.fwd": ("quad_fwd", "frame_ms")}


@pytest.fixture(scope="module")
def quad_root(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("quad"))
    before = _digests(root)
    shutil.copytree(REPO / "portbench/tests/quad_lit", root / "portbench",
                    dirs_exist_ok=True)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "quad_lit", "source": "test",
                             "file": "portbench/configs/quad_lit.json",
                             "reduced": [], "why": "test"})
    for cell, (traffic, metric) in QUAD_CELLS.items():
        bench["workloads"].append({"name": cell, "config": "quad_lit",
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"]:
            if m["name"] == metric:
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, before


@pytest.mark.parametrize("cell", sorted(QUAD_CELLS))
def test_new_scene_shape_runs_from_new_files_only(quad_root, cell):
    """A cell of quad_lit runs to correct through run.run_cell, and half
    the samples under the harness reads incorrect there."""
    root, before = quad_root
    result = run_cpu(root, cell)
    assert result["correct"] is True, result["checks"]
    kind = json.loads((root / "portbench/traffic" /
                       f"{QUAD_CELLS[cell][0]}.json").read_text())["kind"]
    undo = control.plant("half_samples", rtt, torch, kind, device="cpu")
    try:
        assert run_cpu(root, cell)["correct"] is False
    finally:
        undo()
    after = _digests(root)
    assert [p for p in before if before[p] != after.get(p)] == \
        [root / "BENCHMARK.json"]


def test_edge_traffic_on_a_reference_without_edge_terms_raises(quad_root):
    """quad_lit's reference has no edge terms (EDGES None): a traffic that
    turns a sampler on is refused by name before anything renders."""
    from portbench import run
    from portbench.reference import check

    root, _ = quad_root
    cfg, conf = run.load_config(root, "quad_lit")
    traffic = json.loads((root / "portbench/traffic/quad_grad.json")
                         .read_text())
    with pytest.raises(NotImplementedError, match="no edge terms"):
        check.grad_readings(cfg, conf, dict(traffic, primary_edge=True), 1,
                            "cpu")
