"""A copy of the benchmark's data files at a size a CPU test run holds:
the same cells, configurations (their sizes shrunk by their modules'
`tiny`), traffic mixes, limits and per-layer metrics, with small images
and sample counts."""

import json
import shutil
from pathlib import Path

import torch

from portbench import run

REPO = Path(__file__).resolve().parents[2]
SUBDIRS = ("configs", "traffic", "limits", "layer_metrics")


def tiny_root(tmp):
    """A benchmark root under `tmp` holding BENCHMARK.json and shrunk
    copies of portbench/'s data files."""
    root = Path(tmp) / "bench"
    for sub in SUBDIRS:
        shutil.copytree(REPO / "portbench" / sub, root / "portbench" / sub)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for entry in run.load_bench(root)["configs"]:
        cfg, conf = run.load_config(root, entry["name"])
        if hasattr(conf, "tiny"):
            (root / entry["file"]).write_text(json.dumps(conf.tiny(cfg)))
    for path in (root / "portbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t["resolution"], t["num_samples"] = [12, 12], 2
        if "checked_within" in t:
            t["checked_within"], t["checked_frames"] = 3, 2
        path.write_text(json.dumps(t))
    return root


# An edge-sampled cell runs at 32x32, 4 spp: the port draws its edge
# samples in proportion to the lanes, so at 12x12 its edge gradient is
# noise.  edge_grad_gap is held to a limit of this size, set from CPU
# readings of the primary-edge traffic here: sound 0.014-0.115 over 4
# seeds; no_primary_edge, half_edges and flipped_edges 0.18 and above.
EDGE_SIZE = ([32, 32], 4)
EDGE_GRAD_GAP = 0.15


def add_edge_cell(root, name, primary_edge, secondary_edge):
    """A gradient cell of pose_sphere15k with the edge samplers given, made
    only of new files and entries under a tiny_root: grad256_noedge's
    traffic at EDGE_SIZE with the samplers on, and its limits with
    EDGE_GRAD_GAP beside them."""
    pb = Path(root) / "portbench"
    traffic = json.loads((pb / "traffic/grad256_noedge.json").read_text())
    traffic.update(primary_edge=primary_edge, secondary_edge=secondary_edge)
    traffic["resolution"], traffic["num_samples"] = EDGE_SIZE
    (pb / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    limits = json.loads((pb / "limits/pose.grad256_noedge.json").read_text())
    limits["edge_grad_gap"] = EDGE_GRAD_GAP
    (pb / "limits" / f"{name}.json").write_text(json.dumps(limits))
    bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": "pose_sphere15k",
                               "traffic": name, "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "grad_step_ms":
            m["workloads"].append(name)
    (Path(root) / "BENCHMARK.json").write_text(json.dumps(bench))


def run_cpu(root, workload, seconds=0.5, trace=0, seed=2147483659):
    """One run of a cell on the CPU, past the harness's look for a card."""
    torch.set_num_threads(2)
    result, _, _ = run.run_cell(root, workload, seed, seconds, trace,
                             device="cpu", t_start=0.0)
    return result
