#!/usr/bin/env python3
"""Drive redner_tpu_torch's forward render on one CUDA card and hold its
ray-query kernels against their plain PyTorch versions.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   compile csrc/intersect.cu for sm_90a with nvcc (-Xptxas -v);
  2. device  card name and power limit (nvidia-smi); TF32 off;
  3. kernels closest-hit and any-hit kernels against their plain versions on
             the 15,752-triangle slice scene, 65,536 rays per set: random,
             on-geometry (bounce origins at primary hits), and +-1e-5
             straddle pairs across the floor's edge at 1x and 1000x scale;
  4. render  render_image at 256x256, 4 spp, 1 bounce, seed 11: counts the
             kernel launches of that run (8 closest hit, 4 any hit), checks
             the image against the same render through the plain queries on
             the card, and a 32x32 render on the card against the CPU;
  5. times   forward wall time and a torch.profiler breakdown of one
             forward; each kernel per launch at the shapes the render gave
             it (captured from a render), its plain version, and its bound:
             the ray-triangle tests those inputs need x 48 FP32 operations
             over 67 TFLOP/s (H100 SXM, outside the tensor cores);
  6. report  one `kernels` JSON line, the nvidia-smi line, and the final
             {"ok": true, "device": ...} line.

It imports nothing of JAX or redner_tpu.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import redner_tpu_torch as rtt
from redner_tpu_torch import accel
from redner_tpu_torch.camera import sample_primary_rays
from redner_tpu_torch.core.types import Ray
from redner_tpu_torch.ops import intersect as plain
from redner_tpu_torch.ops import intersect_cuda as ic

ROOT = os.path.dirname(os.path.abspath(__file__))

PEAK_FP32_FLOPS = 67e12  # H100 SXM data sheet, FP32 outside tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
# FP32 operations of one ray-triangle test (csrc/intersect.cu test_tri):
# the 19 nonzero coefficients as 4 MUL + 15 FMA = 34 FLOP, then 14 more:
# sign(det), |det|, three sign scales, adet > eps, u >= 0, v >= 0, u + v,
# u + v <= adet, tmin*adet, tmax*adet and the two t compares.  The one
# division per hit is left out.
OPS_PER_TEST = 48
AGREE_MIN = 0.9999  # kernel vs plain: lanes with identical ids/occlusion
PIXEL_AGREE_MIN = 0.999  # kernel vs plain render: pixels within rtol 1e-4
T_RTOL = 1e-5
SEED = 11
REPLACES = {"closest_hit": "redner_tpu/ops/pallas_intersect.py:164",
            "any_hit": "redner_tpu/ops/pallas_intersect.py:323"}
PLAIN = {"closest_hit": plain.closest_plain, "any_hit": plain.anyhit_plain}


def make_slice_scene(res=(256, 256), theta=64, phi=128, device=None):
    """The slice's scene through the user path of bench.py: a UV sphere
    (generate_sphere(64, 128) = 15,748 triangles, the size of the reference
    teapot) with the bench's constant glossy material, a floor quad and a
    quad area light (15,752 triangles in all)."""
    cam = rtt.make_camera(position=[0.0, 1.0, -4.5], look_at=[0.0, -0.2, 0.0],
                          up=[0.0, 1.0, 0.0], fov=45.0, resolution=res,
                          device=device)
    v, f, uv, n = rtt.generate_sphere(theta, phi, device=device)
    glossy = rtt.make_material(diffuse_reflectance=[0.5, 0.5, 0.5],
                               specular_reflectance=[0.2, 0.2, 0.2],
                               roughness=[0.05], device=device)
    gray = rtt.make_material(diffuse_reflectance=[0.4, 0.4, 0.4],
                             device=device)
    floor_v = [[-4.0, -1.0, -4.0], [4.0, -1.0, -4.0], [-4.0, -1.0, 4.0],
               [4.0, -1.0, 4.0]]
    objs = [
        rtt.Object(vertices=v, indices=f, uvs=uv, normals=n, material=glossy),
        rtt.Object(vertices=floor_v, indices=[[0, 2, 1], [1, 2, 3]],
                   material=gray),
        rtt.generate_quad_light(position=[0.0, 4.0, -1.0],
                                look_at=[0.0, 0.0, 0.0], size=[2.0, 2.0],
                                intensity=[20.0, 20.0, 20.0], device=device),
    ]
    return rtt.scene_from_objects(cam, objs)


def _check(cond, msg):
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        sys.exit(1)


# ----------------------------------------------------------------------
# Ray sets
# ----------------------------------------------------------------------


def _rays(org, d, tmin, tmax, dev):
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                  device=dev)
    return Ray(org=t(org), dir=t(d), tmin=t(tmin), tmax=t(tmax))


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def ray_sets(fs, scene, dev, n=65536, seed=0):
    """name -> (FlatScene, Ray for closest hit, Ray for any hit)."""
    rng = np.random.default_rng(seed)
    sets = {}
    inf = np.full(n, np.inf, np.float32)
    tmin = np.full(n, 1e-3, np.float32)
    shadow_tmax = rng.uniform(0.5, 8.0, n).astype(np.float32)

    org = rng.normal(0, 3, (n, 3)).astype(np.float32)
    d = _unit(rng.normal(0, 1, (n, 3)).astype(np.float32))
    sets["random"] = (fs, _rays(org, d, tmin, inf, dev),
                      _rays(org, d, tmin, shadow_tmax, dev))

    # Bounce origins: the hit points of jittered primary rays; lanes that
    # miss take a uniform point on a random triangle.
    cam = scene.camera
    jitter = torch.as_tensor(rng.uniform(0, 1, (n, 2)).astype(np.float32),
                             device=dev)
    with torch.no_grad():
        pr, _ = sample_primary_rays(cam, jitter[: cam.width * cam.height])
        hit = accel.intersect(fs, pr, engine="plain")
        p = (pr.org + pr.dir * hit.t[:, None]).cpu().numpy()
        valid = hit.valid.cpu().numpy()
    verts = fs.vertices.detach().cpu().numpy()
    faces = fs.faces.cpu().numpy()
    tri = rng.integers(0, faces.shape[0], n)
    b = rng.dirichlet([1.0, 1.0, 1.0], n).astype(np.float32)
    on_geo = (b[:, :1] * verts[faces[tri, 0]] + b[:, 1:2] * verts[faces[tri, 1]]
              + b[:, 2:3] * verts[faces[tri, 2]])
    on_geo[: p.shape[0]][valid] = p[valid]
    d = _unit(rng.normal(0, 1, (n, 3)).astype(np.float32))
    sets["on_geometry"] = (fs, _rays(on_geo, d, tmin, inf, dev),
                           _rays(on_geo, d, tmin, shadow_tmax, dev))

    # +-1e-5 straddle pairs across the floor's edge x = 4 (bench.py:58-112
    # geometry, mirrored onto this scene), at 1x and 1000x coordinates.
    P = n // 2
    for s in (1.0, 1000.0):
        fs_s = fs
        if s != 1.0:
            fs_s = dataclasses.replace(fs, vertices=fs.vertices.detach() * s)
            fs_s.layout = ic.coeff_layout_build(fs_s)
        t = np.linspace(0.2, 0.8, P, dtype=np.float32)
        av = np.asarray([4.0, -1.0, -4.0], np.float32) * s
        bv = np.asarray([4.0, -1.0, 4.0], np.float32) * s
        x_edge = (1 - t)[:, None] * av + t[:, None] * bv
        po = np.stack([np.linspace(4.3, 4.5, P) * s, np.full(P, -2.0 * s),
                       np.linspace(-3.0, 3.0, P) * s], -1).astype(np.float32)
        omega = _unit(x_edge - po)
        dxdt = np.broadcast_to(bv - av, (P, 3))
        tang = _unit(dxdt - omega * np.sum(omega * dxdt, -1, keepdims=True))
        n_hat = _unit(np.cross(omega, tang))
        d2 = _unit(np.concatenate([omega + 1e-5 * n_hat, omega - 1e-5 * n_hat]))
        o2 = np.concatenate([po, po])
        st_min = np.full(2 * P, 1e-3 * s, np.float32)
        sets[f"straddle_x{int(s)}"] = (
            fs_s, _rays(o2, d2, st_min, np.full(2 * P, np.inf, np.float32), dev),
            _rays(o2, d2, st_min, np.full(2 * P, 10.0 * s, np.float32), dev))
    return sets


# ----------------------------------------------------------------------
# Timing and bounds
# ----------------------------------------------------------------------


def time_cuda(fn, reps):
    """Median ms per call over `reps` CUDA-event-timed calls, after warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profile_forward(render, top=12):
    """Device-side breakdown of one forward under torch.profiler: CUDA
    kernel count, busy time and idle share of the profiled wall, and the
    kernels that take the most time.  Diagnostics only: a profiler that
    records no device activity prints "not measured" and fails nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except RuntimeError as e:  # profiler unavailable in this environment
        print(f"[profile] not measured: {e}", flush=True)
        return
    if not kern:
        print("[profile] not measured: no device activity recorded", flush=True)
        return
    busy = sum(e.time_range.elapsed_us() for e in kern)
    by_name = {}
    for e in kern:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    print(f"[profile] forward under the profiler: wall {wall_us / 1e3:.3f} ms, "
          f"{len(kern)} CUDA kernels, device busy {busy / 1e3:.3f} ms, idle "
          f"share {1 - busy / wall_us:.3f}", flush=True)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"[profile]   {t / 1e3:9.3f} ms {n:6d}x  {name[:110]}")


def work_bound(fs, rb, steps=None):
    """(bound_ms, bound_by, tests) for one kernel launch on batch rb: the
    ray-triangle tests its data needs (live lanes x real triangles of each
    active chunk, up to the settle point for any hit) x OPS_PER_TEST over
    the FP32 peak, against each input read once and each output written
    once over the HBM rate."""
    lay = fs.layout
    dev = rb.mask.device
    ntile = rb.mask.shape[0]
    real = torch.clamp(fs.num_triangles - torch.arange(lay.nchunks, device=dev)
                       * plain.CHUNK, 0, plain.CHUNK)
    live = torch.zeros(ntile * ic.TILE_N, dtype=torch.int64, device=dev)
    live[: rb.n] = rb.live.to(torch.int64)
    live_per_tile = live.reshape(ntile, ic.TILE_N).sum(dim=1)
    visited = rb.mask
    if steps is not None:  # the first steps[tile] active chunks of each tile
        rank = torch.cumsum(rb.mask.to(torch.int64), dim=1)
        visited = rb.mask & (rank <= steps.to(torch.int64)[:, None])
    tris = (visited.to(torch.int64) * real).sum(dim=1)
    tests = int((tris * live_per_tile).sum())
    nbytes = 4 * (rb.R.numel() + rb.tmin.numel() + rb.tmax.numel()
                  + lay.Tc.numel() + rb.tile_ptr.numel()
                  + rb.tile_chunks.numel() + 2 * rb.R.shape[0])
    t_ops = tests * OPS_PER_TEST / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            tests)


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------


def phase_build():
    t0 = time.perf_counter()
    lib_path, log = ic.build(verbose=True)
    ic._lib()
    print(f"[build] nvcc {' '.join(ic.NVCC_FLAGS)} -> "
          f"{os.path.relpath(lib_path, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in log.strip().splitlines():
        print(f"[build] {line}")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    out = smi.stdout.strip()
    smi_line = (out.splitlines()[0] if out
                else f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi_line}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    _check(torch.backends.cuda.matmul.allow_tf32 is False,
           "torch.backends.cuda.matmul.allow_tf32 must be False")
    _check(torch.backends.cudnn.allow_tf32 is False,
           "torch.backends.cudnn.allow_tf32 must be False")
    return smi_line


def phase_kernels(fs, scene, dev):
    """Kernel vs plain on every ray set; returns per-kernel lane stats."""
    stats = {k: {"bad": 0, "n": 0, "err": 0.0} for k in REPLACES}
    for set_name, (fs_s, ray, sray) in ray_sets(fs, scene, dev).items():
        with torch.no_grad():
            k = accel.intersect(fs_s, ray)
            p = accel.intersect(fs_s, ray, engine="plain")
            ko = accel.occluded(fs_s, sray)
            po = accel.occluded(fs_s, sray, engine="plain")
        torch.cuda.synchronize()
        n = k.tri_id.numel()
        bad = int((k.tri_id != p.tri_id).sum())
        same = (k.tri_id == p.tri_id) & k.valid
        diff = (k.t[same] - p.t[same]).abs()
        rel_max = float((diff / p.t[same].abs()).max()) if diff.numel() else 0.0
        abs_max = float(diff.max()) if diff.numel() else 0.0
        bad_o = int((ko != po).sum())
        print(f"[kernels] {set_name}: closest-hit {bad}/{n} lanes differ, "
              f"{int(k.valid.sum())} hits, t max rel err {rel_max:.3e}; "
              f"any-hit {bad_o}/{n} lanes differ, {int(ko.sum())} blocked",
              flush=True)
        _check(1 - bad / n >= AGREE_MIN, f"{set_name}: tri_id agreement "
               f"{1 - bad / n:.6f} < {AGREE_MIN}")
        _check(1 - bad_o / n >= AGREE_MIN, f"{set_name}: blocked agreement "
               f"{1 - bad_o / n:.6f} < {AGREE_MIN}")
        _check(rel_max <= T_RTOL, f"{set_name}: t rel err {rel_max} > {T_RTOL}")
        for key, b, e in (("closest_hit", bad, abs_max), ("any_hit", bad_o, 0.0)):
            stats[key]["bad"] += b
            stats[key]["n"] += n
            stats[key]["err"] = max(stats[key]["err"], e)
        if set_name.startswith("straddle"):
            hits = k.valid.cpu().numpy()
            P = hits.shape[0] // 2
            frac = float(np.mean(hits[:P] != hits[P:]))
            print(f"[kernels] {set_name}: split fraction {frac:.4f}",
                  flush=True)
            _check(frac > 0.8, f"{set_name}: straddle split fraction {frac}")
    return stats


def phase_render(scene, opts):
    """The main path once with the launch counts zeroed just before and read
    just after; then the image checks.  Returns the launch counts."""
    with torch.no_grad():
        rtt.render_image(scene, opts, seed=SEED)  # warm-up
        torch.cuda.synchronize()
        ic.reset_launch_counts()
        img = rtt.render_image(scene, opts, seed=SEED)
        torch.cuda.synchronize()
        launches = dict(ic.LAUNCHES)
    print(f"[render] main path launches: {launches}", flush=True)
    _check(launches == {"closest_hit": 8, "any_hit": 4},
           f"main path launches {launches}, want 8 closest hit + 4 any hit")
    _check(tuple(img.shape) == (256, 256, 3), f"image shape {tuple(img.shape)}")
    _check(bool(torch.isfinite(img).all()), "image has non-finite values")
    img_max = float(img.max())
    _check(img_max > 0, "image is black")
    with torch.no_grad():
        ref = rtt.render_image(scene, opts, seed=SEED, engine="plain")
    close = torch.isclose(img, ref, rtol=1e-4, atol=1e-6 * img_max).all(dim=-1)
    n_diff = int((~close).sum())
    print(f"[render] 256x256 4spp: mean {float(img.mean()):.6f} max "
          f"{img_max:.4f}; {n_diff}/{close.numel()} pixels differ from the "
          f"plain-query render (rtol 1e-4, atol 1e-6 x max)", flush=True)
    _check(1 - n_diff / close.numel() >= PIXEL_AGREE_MIN,
           f"{n_diff} pixels differ from the plain-query render")
    with torch.no_grad():
        a = rtt.render_image(make_slice_scene(res=(32, 32), device="cuda"),
                             opts, seed=SEED).cpu()
        b = rtt.render_image(make_slice_scene(res=(32, 32), device="cpu"),
                             opts, seed=SEED)
    close = torch.isclose(a, b, rtol=1e-4, atol=1e-6 * float(b.max())).all(-1)
    n_diff = int((~close).sum())
    print(f"[render] 32x32 card vs CPU: {n_diff}/{close.numel()} pixels "
          f"differ (rtol 1e-4)", flush=True)
    _check(n_diff <= 0.01 * close.numel(), "card and CPU renders disagree")
    return launches


def phase_times(fs, scene, opts):
    """Forward wall time, a profile, and per-launch kernel/plain times at
    the main path's shapes.  Returns (forward ms, per-kernel rows)."""
    walls = []
    with torch.no_grad():
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rtt.render_image(scene, opts, seed=SEED)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    fwd_ms = statistics.median(walls)
    print(f"[times] forward 256x256 4spp 1 bounce: median {fwd_ms:.3f} ms "
          f"of {len(walls)} (all: {', '.join(f'{w:.2f}' for w in walls)}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
          flush=True)
    with torch.no_grad():
        profile_forward(lambda: rtt.render_image(scene, opts, seed=SEED))

    # Capture each kernel's main-path inputs from one more render.
    captured = []
    wrappers = {"closest_hit": ic.closest_hit, "any_hit": ic.any_hit}

    def recorder(kind):
        def run(Tc, rb):
            captured.append((kind, Tc, rb))
            return wrappers[kind](Tc, rb)
        return run

    ic.closest_hit, ic.any_hit = recorder("closest_hit"), recorder("any_hit")
    try:
        with torch.no_grad():
            rtt.render_image(scene, opts, seed=SEED)
    finally:
        ic.closest_hit, ic.any_hit = wrappers["closest_hit"], wrappers["any_hit"]
    torch.cuda.synchronize()

    per = {k: [] for k in REPLACES}
    for i, (kind, Tc, rb) in enumerate(captured):
        kfn, pfn = wrappers[kind], PLAIN[kind]
        with torch.no_grad():
            k_ms = time_cuda(lambda: kfn(Tc, rb), 9)
            p_ms = time_cuda(lambda: pfn(Tc, rb), 5)
            kout, pout = kfn(Tc, rb), pfn(Tc, rb)
        if kind == "closest_hit":
            bound, by, tests = work_bound(fs, rb)
            same = kout[1].to(torch.int64) == pout[1]
            fin = same & torch.isfinite(pout[0])
            err = float((kout[0][fin] - pout[0][fin]).abs().max()) \
                if fin.any() else 0.0
            bad = int((~same).sum())
        else:
            bound, by, tests = work_bound(fs, rb, steps=kout[1])
            differ = (kout[0] != 0) != pout[0]
            err = float(differ.any())
            bad = int(differ.sum())
            _check(bool((kout[1].to(torch.int64) == pout[1]).all()),
                   "any-hit settle points differ from the plain version")
        _check(bad <= (1 - AGREE_MIN) * rb.n,
               f"launch {i} {kind}: {bad} lanes differ from the plain version")
        per[kind].append(dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, by=by,
                              err=err))
        print(f"[times] launch {i} {kind}: {rb.n} rays, {int(rb.mask.sum())} "
              f"active (tile, chunk) pairs of {rb.mask.numel()}, {tests} "
              f"ray-triangle tests; kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
              f"bound {bound:.4f} ms ({by}); {bad} lanes differ", flush=True)
    _check(len(per["closest_hit"]) == 8 and len(per["any_hit"]) == 4,
           f"captured {[(k, len(v)) for k, v in per.items()]}")
    return fwd_ms, per


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    phase_build()
    smi_line = phase_device()

    scene = make_slice_scene(device=dev)
    fs = rtt.flatten_scene(scene)
    _check(fs.num_triangles == 15752,
           f"slice scene has {fs.num_triangles} triangles, want 15752")
    print(f"[kernels] scene: {fs.num_triangles} triangles, "
          f"{fs.layout.nchunks} chunks of {plain.CHUNK}", flush=True)
    stats = phase_kernels(fs, scene, dev)

    opts = rtt.RenderOptions(num_samples=4, max_bounces=1)
    launches = phase_render(scene, opts)
    fwd_ms, per = phase_times(fs, scene, opts)

    kernels = []
    for kind, rows in per.items():
        mean = lambda key: statistics.fmean(r[key] for r in rows)
        kernels.append({
            "name": kind,
            "route": "cuda",
            "source": "redner_tpu_torch/csrc/intersect.cu",
            "replaces": REPLACES[kind],
            "launches": launches[kind],
            "max_abs_err": max(max(r["err"] for r in rows), stats[kind]["err"]),
            "ms": mean("ms"),
            "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": ("operations" if all(r["by"] == "operations"
                                             for r in rows) else "bytes"),
            "library_ms": None,
            "mismatched_lanes": stats[kind]["bad"],
            "compared_lanes": stats[kind]["n"],
            "forward_ms": fwd_ms,
        })
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
