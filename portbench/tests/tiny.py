"""A copy of the benchmark's data files at a size a CPU test run holds:
the same cells, configurations, traffic mixes, limits and per-layer
metrics, with small meshes, images and sample counts."""

import json
import shutil
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
SUBDIRS = ("configs", "traffic", "limits", "layer_metrics")


def tiny_root(tmp):
    """A benchmark root under `tmp` holding BENCHMARK.json and shrunk
    copies of portbench/'s data files."""
    root = Path(tmp) / "bench"
    for sub in SUBDIRS:
        shutil.copytree(REPO / "portbench" / sub, root / "portbench" / sub)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for path in (root / "portbench" / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["sphere"]["theta_steps"], c["sphere"]["phi_steps"] = 6, 12
        path.write_text(json.dumps(c))
    for path in (root / "portbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t["resolution"], t["num_samples"] = [12, 12], 2
        if "checked_within" in t:
            t["checked_within"], t["checked_frames"] = 3, 2
        path.write_text(json.dumps(t))
    return root


def run_cpu(root, workload, seconds=0.5, trace=0, seed=2147483659):
    """One run of a cell on the CPU, past the harness's look for a card."""
    from portbench import run

    torch.set_num_threads(2)
    result, _, _ = run.run_cell(root, workload, seed, seconds, trace,
                             device="cpu", t_start=0.0)
    return result
