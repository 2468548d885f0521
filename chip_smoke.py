#!/usr/bin/env python3
"""Drive redner_tpu_torch's forward render and its edge-sampled gradient on
one CUDA card and hold its ray-query kernels against their plain PyTorch
versions.

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
             it (captured from a render): the kernel alone (its output fill
             and launch; CUDA events around 20 back-to-back calls, median
             of 5 such runs), the wrapper, the plain version, and the
             bound: the ray-triangle tests those inputs need x 48 FP32
             operations over 67 TFLOP/s (H100 SXM, outside the tensor
             cores); then the same for the random and on-geometry ray sets
             of phase 3;
  6. grad    the edge-sampled gradient: loss = render(...).sum() on the
             slice at 256x256, 4 spp, 1 bounce, seed 11, both edge
             samplers on (65,536 primary-edge samples), differentiated
             w.r.t. the sphere's vertices, the light intensity, the
             sphere's diffuse reflectance and the camera position.  Counts
             the kernel launches of one gradient evaluation (forward +
             backward; 32 closest hit + 16 any hit by the code), holds each
             kernel against its plain version on a primary-edge chunk and a
             secondary-edge pair batch captured from a gradient evaluation
             (and reports the share of pairs whose two sides hit
             differently), compares the gradient with the one through the
             plain queries on the card (64x64) and with the CPU's (32x32),
             and times fwd+bwd, its peak memory, a profile of one gradient
             evaluation and each kernel per launch on the edge-pair rays.
             The card-vs-CPU comparison is traced: both runs record every
             discrete decision (hit ids, blocked, edge picks, Morton keys,
             light / triangle / envmap picks), the lanes that differ are
             counted per kind, and the card runs again with the CPU's
             decisions replayed: what remains must agree to relative L2
             1e-4;
  7. envtex  the slice's geometry with image textures and an envmap: the
             sphere carries a 512x512x3 diffuse texture, a 512x512x1
             roughness texture and a 512x512x3 normal map, and a 256x512x3
             HDR envmap (sky gradient + sun lobe) lights the scene beside
             the area light, all made from SEED (11) with numpy.  Counts the
             launches of one forward (8 closest hit + 4 any hit: envmap
             shadow rays share the area light's any-hit sweep) and of one
             gradient evaluation (32 + 16) w.r.t. the sphere's vertices,
             its diffuse texels, the envmap's texels and the light
             intensity; checks that the background shows the envmap;
             holds the any-hit kernel against anyhit_plain (0 differing
             lanes) on the forward's shadow batch, whose envmap lanes
             have tmax = inf, and times it against its bound; compares the
             card with the CPU (32x32 image and gradient) and the gradient
             through the kernels with the one through the plain queries
             (64x64); times the forward and fwd+bwd, peak memory, and
             profiles one gradient evaluation;
  8. aov     the user utilities on the envtex scene with a 512x512x16
             generic texture on the sphere and vertex colours on the floor:
             render_g_buffer with all 16 channels (C = 47; Sobol, 1 spp, 0
             bounces), render_deferred with the four light kinds, alpha and
             2x2 supersampling (one 512x512 pass of 262,144 rays),
             render_pathtracing (4 spp, 1 bounce, Sobol) and
             screen_gradient_image (4 spp, Sobol, primary edges); gradients
             of the first three under a loss that reads every channel.
             Counts the launches of each forward and gradient (the any-hit
             kernel only under radiance), holds both kernels against their
             plain versions on the captured batches and times the
             262,144-ray batch against its bound, compares each image
             through the kernels with the plain queries' (64x64) and the
             card with the CPU (32x32: images, gradients), and times each
             render, its peak memory, the CUDA kernels of one Sobol and
             one independent draw and a profile of one G-buffer
             gradient;
  9. files   the envtex scene written to a temporary directory as a user
             ships one (write_files_scene): the sphere as an OBJ with
             per-face split vertices at %.6g, its 512x512 diffuse texture
             and the 256x512 envmap as EXR, a Mitsuba XML with a toWorld
             lookat sensor and a 256x256 film (no roughness texture and no
             normal map: the loader reads neither); loaded onto the card
             and the CPU with rtt.load_mitsuba; the welded sphere's edge
             table against the unsplit mesh's; then the launches of one
             forward and one gradient (w.r.t. the sphere's vertices,
             cam_to_world, intrinsic_mat, the diffuse and the envmap
             texels), kernels against plain versions on every captured
             batch, the image through the kernels against the plain
             queries (64x64), card against CPU (32x32: image and each
             leaf's gradient), fwd+bwd (median of 3) and peak memory;
 10. cameras the loaded scene under an orthographic, a fisheye, a panorama
             and a distorted perspective camera (k1 = 0.1, p1 = 0.001), at
             256x256 with the same checks (distortion_params among the
             distorted camera's leaves; fwd+bwd median of 3 for the
             fisheye, one call for the others); the fisheye's (dead lanes
             outside the image circle, checked as misses) and the
             panorama's camera-ray launches timed against their bounds;
 11. frontend the slice scene built through redner_tpu_torch.frontend (the
             pyredner-style classes: Camera, Object, Material,
             generate_quad_light, Scene(objects=...)) at 256x256, 4 spp, 1
             bounce, seed 11: pyredner.render against rtt.render on
             make_slice_scene (pixels, and the gradient w.r.t. the sphere's
             vertices and diffuse, the light intensity and the camera
             position), the launches of one forward and one gradient, five
             Adam steps of tutorial 01's inverse-rendering loop on the
             diffuse (the loss must fall), the front end's deferred and
             G-buffer renders of the aov scene against the functional ones,
             and the front end's remat=True gradient against its live one;
             then remat on the slice's gradient against the live gradient:
             launches, fwd+bwd (median of 3, interleaved with the live
             one), peak memory and a profile of each (CUDA kernels, device
             busy); isect_replay_max_mb=256, which the port accepts and
             which changes nothing: the live launches and gradient;
 12. sharded the slice's gradient (256x256, 4 spp, 1 bounce, both edge
             samplers) over two ranks spawned on the one card (gloo: NCCL
             refuses two ranks on one device) and over a one-rank NCCL
             group, against one process: every pixel within atol 1e-6,
             each leaf's gradient within relative L2 1e-4, the ranks'
             gradients equal; five steps of make_train_step on the
             sphere's diffuse (the loss falls at every step and matches
             one process within rtol 1e-3); launches per rank (28 + 14 by
             the code), peak memory per rank, fwd+bwd of one process
             against the two ranks'; the second derivative through
             render_sharded and render_image_sharded on the gloo pair and
             the one-rank NCCL group (checked in [second_order]).  The
             gloo pair runs eagerly, by its
             group's backend (its calls capture nothing).  The one-rank
             NCCL group also replays graphs with its collectives captured:
             render_sharded graphed against its eager route and against
             one process, with the checks of [graph]'s routes below; and
             five graphed make_train_step steps, edge-sampled and
             continuous, against one process's eager steps (losses within
             rtol 1e-3, falling), the step's wall and the CUDA kernels and
             idle share of one step;
 13. graph   the compiled render: rtt.render, rtt.render_image (with and
             without autograd) and rtt.screen_gradient_image replay cached
             CUDA graphs (redner_tpu_torch.graphs).  The eager slice,
             envtex and G-buffer gradients under
             torch.cuda.set_sync_debug_mode("error") (no host sync); the
             slice, envtex and G-buffer gradients and one remat gradient
             graphed against eager at seeds 11 and 12 and after an in-place
             update of the vertices (every pixel within atol 1e-6, each
             leaf's gradient within relative L2 1e-4, printed beside the
             eager-vs-eager value; the first call of a key eager, one
             capture at the second, none on later calls, capture
             seconds); render_image graphed against eager
             and its forward wall (median of 5); the front end's five Adam
             steps (losses within rtol 1e-3); the kernel nodes per graphed
             gradient (32 + 16, counted at capture and in a profile of the
             replays); both kernels against their plain versions on every
             batch of one gradient through the device-count interface (0
             lanes off); fwd+bwd eager and graphed (median of 3) per path,
             the device busy and idle share of one graphed gradient, the
             peak memory eager and graphed, the memory the graph cache
             holds, and one 1024x1024 x 4 spp slice gradient eager against
             graphed (the device-bound contrast).  Then two more routes,
             each with the same checks (graph_route): the slice's
             continuous gradient through render_image under autograd, and
             the aov scene's screen gradient (4 spp, Sobol, primary edges;
             forward only, its image within relative L2 1e-4 of eager: its
             edge scatter sums with atomics): its eager route under sync
             debug mode "error", graphed against eager, its launch counts
             zeroed before its first graphed call, its kernel nodes at
             capture and in a profile of the replays against the eager
             route's launches (twice them for render_image, whose graphed
             backward re-renders the forward), its kernels against their
             plain versions on every batch, its wall eager and graphed
             (median of 3) and the busy and idle share of one graphed run;
             then the screen gradient's loop (SCREEN_ROUNDS rounds,
             --screen-rounds N): its graph released and captured again,
             then two eager runs, every image within relative L2 1e-4 of
             the others (a round that fails saves its images and the
             eager runs' primary-edge samples under OUT_DIR);
 14. second_order  the slice's second derivative (256x256, 4 spp):
             d/dleaves sum_i <u_i, d sum(image^2) / d leaf_i> through
             rtt.render and rtt.render_image, the first gradient taken
             with create_graph (its backward, and the continuous backward
             of the image, run eagerly on the graph cache's route:
             graphs.EAGER["create_graph"], 6 per route), against
             graphs.disable(): relative L2 <= 1e-4 per leaf, printed
             beside eager against eager; walls; the launches of the phase.
             Then the sharded second derivatives that [sharded] computed
             (render_sharded and render_image_sharded on the two gloo
             ranks sharing the card and on the one-rank NCCL group)
             against the one-process eager one: relative L2 <= 1e-4 per
             leaf, finite, the gloo ranks equal, both kernels launched in
             each run, and each run's wall;
 15. tutorials  each file of tutorials/torch_port at its own size (64x64;
             05: 32x32 then 64x64 at 2 bounces) for 6 steps (05: 4 a
             level), graphed and inside graphs.disable(): losses finite,
             falling over each level and within rtol 1e-3 of eager; the
             launches of the graphed run (counted from zero), its graphs
             captured and replayed, and each step's wall;
 16. gather  gather_rows and scatter_rows (csrc/gather.cu) at the gradient
             cell's shapes, 65,536 lanes over the light (1x3), material
             (3x3, 3x12) and face (15,752x34) tables, ids all equal, the
             slice's hit record in swizzled order, and random: each kernel
             against its plain version, times against the plain versions,
             index_put_(accumulate=True) and index_add_ (yardsticks the
             port never calls) and the bytes' bound, the small tables'
             scatters on the warp variant too (the one the block variant
             spares), the merge factor (lane-columns over updates) at each
             site of one eager gradient of the cell's render, and the
             gather_cuda launches that phases 4-15 counted on each route
             beside intersect_cuda's (the render's: gathers and no
             scatter; the gradient's: every kernel);
 17. report  one `kernels` JSON line, a `gather` JSON line, the nvidia-smi
             line, and the final {"ok": true, "device": ...} line.

Phases 4-11 run inside graphs.disable(): every entry point runs eagerly,
from Python, so their launch counts, captured batches and decision traces
see every launch and their numbers stay comparable with the eager
render's.  So do --memory's live and remat cells and the eager side of
every graphed check.  [sharded] runs its one-process and gloo parts
eagerly and its NCCL part both ways; [graph] runs the graphs.

    python3 chip_smoke.py --memory

runs only the memory measurement (phase_memory, eager): the peak device
memory of the slice's gradient with and without remat, at 256x256 x 4 spp
and at 1024x1024 x 16 and x 32 spp, with the secondary-edge candidate draw
in runs of lanes (edge.CANDIDATE_CHUNK) and, but at 32 spp, in one run;
and what the allocations live at the peak are, by the line of the port
that made them; then the gradient through the graph cache
(graphed_memory): 256x256 x 4 spp, then with no clear() between them two
1024x1024 x 16 spp keys (the second's first call releases the first's
graphs), the 1024x1024 x 32 spp key (eager where its graphs would not
fit the card, each eager call making room first), the second 16 spp key
again and the 32 spp key again: each call's route, peak, wall and the
bytes each cached key keeps.

    python3 chip_smoke.py --graph-memory

runs graphed_memory alone.

    python3 chip_smoke.py --gather

runs the build, the device line and phase 16 alone (about a minute).

    python3 chip_smoke.py --cards N

runs only the lane split over N cards (phase_cards): the slice's gradient
at 256x256 x 4 spp and 1024x1024 x 4 spp on N spawned ranks, one card
each over NCCL, against one process on the first card, all replaying
graphs: pixels, gradients, kernel nodes and peak memory per rank, fwd+bwd
of one graphed card against the ranks'; then MIXED_CALLS gradients at
256x256 x 4 spp in which the ranks take different routes at the same
call (each rank empties its graph cache before a different call, so one
runs eagerly while others capture or replay): every call's gradients
equal on every rank and within relative L2 1e-4 of one process's; and
MIXED_CALLS second derivatives through render_sharded and
render_image_sharded in the same way (the forwards on different routes,
the two eager backwards' collectives meeting across the ranks): equal on
every rank and within relative L2 1e-4 of one process's.

    python3 chip_smoke.py --screen-rounds N

runs the whole script with N rounds of [graph]'s screen-gradient loop.

It imports nothing of JAX or redner_tpu.
"""

import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

import redner_tpu_torch as rtt
import redner_tpu_torch.frontend as pyredner
from redner_tpu_torch import accel, graphs
from redner_tpu_torch import edge as edge_mod
from redner_tpu_torch import sampler as sampler_mod
from redner_tpu_torch.camera import sample_primary_rays
from redner_tpu_torch.core import vecmath as vm
from redner_tpu_torch.core.types import Ray
from redner_tpu_torch.ops import gather_cuda as gcu
from redner_tpu_torch.ops import intersect as plain
from redner_tpu_torch.ops import intersect_cuda as ic
from redner_tpu_torch.ops.nvcc import NVCC_FLAGS
from redner_tpu_torch.parallel.sharding import (make_mesh, make_train_step,
                                                render_image_sharded,
                                                render_sharded)
from redner_tpu_torch.parallel.spawn import COLLECTIVE_TIMEOUT, run_ranks

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


def make_slice_scene(res=(256, 256), theta=64, phi=128, sphere_material=None,
                     envmap=None, floor_colors=None, device=None):
    """The slice's scene through the user path of bench.py: a UV sphere
    (generate_sphere(64, 128) = 15,748 triangles, the size of the reference
    teapot) with the bench's constant glossy material unless
    `sphere_material` is given, a floor quad (with per-vertex
    `floor_colors` if given) and a quad area light (15,752 triangles in
    all), and `envmap` if given."""
    cam = rtt.make_camera(position=[0.0, 1.0, -4.5], look_at=[0.0, -0.2, 0.0],
                          up=[0.0, 1.0, 0.0], fov=45.0, resolution=res,
                          device=device)
    v, f, uv, n = rtt.generate_sphere(theta, phi, device=device)
    if sphere_material is None:
        sphere_material = rtt.make_material(
            diffuse_reflectance=[0.5, 0.5, 0.5],
            specular_reflectance=[0.2, 0.2, 0.2], roughness=[0.05],
            device=device)
    gray = rtt.make_material(diffuse_reflectance=[0.4, 0.4, 0.4],
                             device=device)
    floor_v = [[-4.0, -1.0, -4.0], [4.0, -1.0, -4.0], [-4.0, -1.0, 4.0],
               [4.0, -1.0, 4.0]]
    objs = [
        rtt.Object(vertices=v, indices=f, uvs=uv, normals=n,
                   material=sphere_material),
        rtt.Object(vertices=floor_v, indices=[[0, 2, 1], [1, 2, 3]],
                   colors=floor_colors, material=gray),
        rtt.generate_quad_light(position=[0.0, 4.0, -1.0],
                                look_at=[0.0, 0.0, 0.0], size=[2.0, 2.0],
                                intensity=[20.0, 20.0, 20.0], device=device),
    ]
    return rtt.scene_from_objects(cam, objs, envmap=envmap)


def _smooth_noise(rng, h, w, c, octaves=4):
    """Seeded smooth noise in [0, 1] of shape (h, w, c): a sum of random
    sinusoids over the (u, v) torus plus a faint checker."""
    v = (np.arange(h, dtype=np.float64)[:, None, None] + 0.5) / h
    u = (np.arange(w, dtype=np.float64)[None, :, None] + 0.5) / w
    out = np.zeros((h, w, c))
    for k in range(octaves):
        f = 2.0 ** (k + 1)
        fu, fv = rng.integers(1, int(f) + 1, (2, c))
        ph = rng.uniform(0, 2 * np.pi, (2, c))
        out += (0.5 ** k) * np.sin(2 * np.pi * fu * u + ph[0]) * np.cos(
            2 * np.pi * fv * v + ph[1])
    checker = ((np.floor(u * 16) + np.floor(v * 16)) % 2) * 0.2
    out = out + checker
    return (out - out.min()) / (out.max() - out.min())


def envtex_arrays(tex=512, env=(256, 512), seed=SEED, generic=0):
    """The envtex scene's images as numpy arrays, made from `seed`: the
    sphere's tex x tex x 3 diffuse texture, tex x tex x 1 roughness and
    tex x tex x 3 normal map, an env[0] x env[1] x 3 HDR envmap (sky
    gradient + one bright sun lobe, so that importance sampling matters),
    and with generic > 0 a tex x tex x generic generic texture."""
    rng = np.random.default_rng(seed)
    nz = _smooth_noise(rng, tex, tex, 2)
    out = {"generic": None}
    if generic:
        out["generic"] = _smooth_noise(np.random.default_rng(seed + 1), tex,
                                       tex, generic).astype(np.float32)
    out["diffuse"] = (0.1 + 0.8 * _smooth_noise(rng, tex, tex, 3)
                      ).astype(np.float32)
    out["roughness"] = (0.05 + 0.45 * _smooth_noise(rng, tex, tex, 1)
                        ).astype(np.float32)
    out["normal_map"] = np.concatenate(
        [0.4 + 0.2 * nz, np.ones((tex, tex, 1))], axis=-1).astype(np.float32)
    eh, ew = env
    th = (np.arange(eh)[:, None] + 0.5) / eh
    ph = (np.arange(ew)[None, :] + 0.5) / ew
    sky = np.stack([0.25 + 0.5 * (1 - th), 0.35 + 0.45 * (1 - th),
                    0.6 + 0.3 * (1 - th)], -1) * np.ones((eh, ew, 1))
    sun_th, sun_ph = rng.uniform(0.15, 0.35), rng.uniform(0.0, 1.0)
    dph = np.minimum(np.abs(ph - sun_ph), 1 - np.abs(ph - sun_ph))
    sun = 200.0 * np.exp(-((th - sun_th) ** 2 + dph ** 2) / 2e-4)
    out["envmap"] = (sky + sun[..., None] * np.asarray([1.0, 0.95, 0.8])
                     + rng.uniform(0, 0.02, (eh, ew, 3))).astype(np.float32)
    return out


def make_envtex_scene(res=(256, 256), theta=64, phi=128, tex=512,
                      env=(256, 512), seed=SEED, generic=0, device=None):
    """The slice's scene with image textures and an environment map
    (envtex_arrays): the sphere has a diffuse texture, a roughness texture
    and a normal map, and the HDR envmap lights the scene beside the quad
    light.  generic > 0 adds a generic texture to the sphere and vertex
    colours to the floor (the aov phase's scene)."""
    arr = envtex_arrays(tex, env, seed, generic)
    floor_colors = None
    if generic:
        floor_colors = [[0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.2, 0.9],
                        [0.9, 0.9, 0.2]]
    textured = rtt.make_material(
        diffuse_reflectance=arr["diffuse"],
        specular_reflectance=[0.2, 0.2, 0.2], roughness=arr["roughness"],
        generic_texture=arr["generic"], normal_map=arr["normal_map"],
        device=device)
    envmap = rtt.make_environment_map(arr["envmap"], device=device)
    return make_slice_scene(res, theta, phi, sphere_material=textured,
                            envmap=envmap, floor_colors=floor_colors,
                            device=device)


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


def time_cuda(fn, reps, rounds=5):
    """ms per call: CUDA events around `reps` back-to-back calls, after a
    warm-up; (median, min, max) over `rounds` such runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times), min(times), max(times)


def kernel_only(kind, lay, rb):
    """A call that runs just the kernel on batch rb: its output fill and
    the launch (the wrapper also unpacks the closest-hit keys), and the
    output it writes."""
    closest = kind == "closest_hit"
    out = torch.empty((rb.R.shape[0],), device=rb.R.device,
                      dtype=torch.int64 if closest else torch.int32)

    def run():
        out.fill_(ic.NO_HIT if closest else 0)
        ic._launch("rt_" + kind, lay, rb, out)
    return run, out


def profile_run(label, run, top=12):
    """Device-side breakdown of one run under torch.profiler: CUDA kernel
    count, busy time and idle share of the profiled wall, and the kernels
    that take the most time.  Only device activity is recorded (the host's
    op events of a 100k-kernel run cost the profiler tens of seconds to
    collect).  Returns {"kernels", "busy_ms", "wall_ms", "idle", "by_name":
    {name: count}}, or None when not measured: a profiler that records no
    device activity prints "not measured" and fails nothing here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_start = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except RuntimeError as e:  # profiler unavailable in this environment
        print(f"[profile] not measured: {e}", flush=True)
        return None
    if not kern:
        print("[profile] not measured: no device activity recorded", flush=True)
        return None
    busy = sum(e.time_range.elapsed_us() for e in kern)
    by_name = {}
    for e in kern:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    print(f"[profile] {label} under the profiler: wall {wall_us / 1e3:.3f} ms, "
          f"{len(kern)} CUDA kernels, device busy {busy / 1e3:.3f} ms, idle "
          f"share {1 - busy / wall_us:.3f}", flush=True)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"[profile]   {t / 1e3:9.3f} ms {n:6d}x  {name[:110]}")
    print(f"[profile] device activity only; the profile took "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return {"kernels": len(kern), "busy_ms": busy / 1e3,
            "wall_ms": wall_us / 1e3, "idle": 1 - busy / wall_us,
            "by_name": {n: c for n, (c, _) in by_name.items()}}


def work_bound(fs, rb, steps=None):
    """(bound_ms, bound_by, tests) for one kernel launch on batch rb: the
    ray-triangle tests its data needs (live lanes x real triangles of each
    active chunk, for any hit up to the settle point `steps` that
    anyhit_plain reports, so the bound does not move with the kernel) x
    OPS_PER_TEST over the FP32 peak, against each input read once and each
    output written once over the HBM rate."""
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
                  + lay.Tp.numel() + 2 * int(rb.count) + 1
                  + 2 * rb.R.shape[0])
    t_ops = tests * OPS_PER_TEST / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            tests)


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------


# gather_cuda's launches on each route the script drives ({route: counts}),
# read where the route reads intersect_cuda's; phase_gather reports them.
GATHER_ROUTES = {}


def reset_launches():
    """Zeros both kernel modules' launch counts."""
    ic.reset_launch_counts()
    gcu.reset_launch_counts()


def note_gather(route):
    """Records (and returns) gather_cuda's launches since reset_launches()
    as the route's."""
    GATHER_ROUTES[route] = dict(gcu.LAUNCHES)
    return GATHER_ROUTES[route]


def phase_build():
    t0 = time.perf_counter()
    lib_path, log = ic.build(verbose=True)
    ic._lib()
    print(f"[build] nvcc {' '.join(NVCC_FLAGS)} -> "
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
          f"torch {torch.__version__} cuda {torch.version.cuda} nccl "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
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
        reset_launches()
        img = rtt.render_image(scene, opts, seed=SEED)
        torch.cuda.synchronize()
        launches = dict(ic.LAUNCHES)
        gathers = note_gather("render")
    print(f"[render] main path launches: {launches}; row gathers "
          f"{gathers}", flush=True)
    _check(launches == {"closest_hit": 8, "any_hit": 4},
           f"main path launches {launches}, want 8 closest hit + 4 any hit")
    _check(gathers["gather_rows"] > 0 and gathers["scatter_rows.block"]
           + gathers["scatter_rows.warp"] == 0,
           f"main path row gathers {gathers}: want gathers and no scatter")
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
        for _ in range(5):
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
        profile_run("forward", lambda: rtt.render_image(scene, opts, seed=SEED))

    # Capture each kernel's main-path inputs from one more render.
    with torch.no_grad():
        captured = capture_launches(lambda: rtt.render_image(scene, opts,
                                                             seed=SEED))
    per = {k: [] for k in REPLACES}
    for i, (kind, rb) in enumerate(captured):
        per[kind].append(measure_launch(f"launch {i}", kind, fs, rb))
    _check(len(per["closest_hit"]) == 8 and len(per["any_hit"]) == 4,
           f"captured {[(k, len(v)) for k, v in per.items()]}")
    return fwd_ms, per


def capture_launches(run):
    """[(kind, RayBatch)] of every kernel launch that run() makes, in order."""
    captured = []
    wrappers = {"closest_hit": ic.closest_hit, "any_hit": ic.any_hit}

    def recorder(kind):
        def rec(lay, rb):
            captured.append((kind, rb))
            return wrappers[kind](lay, rb)
        return rec

    ic.closest_hit, ic.any_hit = recorder("closest_hit"), recorder("any_hit")
    try:
        run()
    finally:
        ic.closest_hit, ic.any_hit = wrappers["closest_hit"], wrappers["any_hit"]
    torch.cuda.synchronize()
    return captured


def measure_launch(label, kind, fs, rb):
    """One kernel on batch rb: its time, its plain version's, its bound,
    and its agreement with the plain version (exact for any hit)."""
    lay = fs.layout
    kfn = {"closest_hit": ic.closest_hit, "any_hit": ic.any_hit}[kind]
    pfn = PLAIN[kind]
    run, _ = kernel_only(kind, lay, rb)
    with torch.no_grad():
        k_ms, k_lo, k_hi = time_cuda(run, 20)
        w_ms, _, _ = time_cuda(lambda: kfn(lay, rb), 20, rounds=3)
        p_ms, _, _ = time_cuda(lambda: pfn(lay.Tc, rb), 1, rounds=3)
        kout, pout = kfn(lay, rb), pfn(lay.Tc, rb)
    if kind == "closest_hit":
        bound, by, tests = work_bound(fs, rb)
        same = kout[1].to(torch.int64) == pout[1]
        fin = same & torch.isfinite(pout[0])
        err = float((kout[0][fin] - pout[0][fin]).abs().max()) \
            if fin.any() else 0.0
        bad = int((~same).sum())
        _check(bad <= (1 - AGREE_MIN) * rb.n,
               f"{label} {kind}: {bad} lanes differ from the plain version")
    else:
        bound, by, tests = work_bound(fs, rb, steps=pout[1])
        differ = (kout != 0) != pout[0]
        err = float(differ.any())
        bad = int(differ.sum())
        _check(bad == 0, f"{label} {kind}: blocked differs from the plain "
               f"version on {bad} lanes")
    cnt = rb.mask.sum(dim=1).to(torch.float64)
    print(f"[times] {label} {kind}: {rb.n} rays, {int(rb.count)} active "
          f"(tile, chunk) pairs of {rb.mask.numel()}, active chunks per tile "
          f"mean {float(cnt.mean()):.2f} max {int(cnt.max())}, {tests} "
          f"ray-triangle tests; kernel {k_ms:.4f} ms ({k_lo:.4f}-{k_hi:.4f}), "
          f"with the wrapper {w_ms:.4f} ms, plain {p_ms:.3f} ms, bound "
          f"{bound:.4f} ms ({by}), time/bound {k_ms / bound:.2f}; {bad} lanes "
          f"differ", flush=True)
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, by=by, err=err)


def phase_sets(fs, scene, dev):
    """Each kernel timed on the incoherent random and on-geometry sets of
    phase 3 (the kind of rays the edge passes send), with its bound."""
    sets = ray_sets(fs, scene, dev)
    out = {}
    for name in ("random", "on_geometry"):
        fs_s, ray, sray = sets[name]
        for kind, r in (("closest_hit", ray), ("any_hit", sray)):
            with torch.no_grad():
                rb = ic.prepare_rays(fs_s, r)
            row = measure_launch(name, kind, fs_s, rb)
            out[f"{name}/{kind}"] = {k: row[k] for k in ("ms", "bound_ms")}
    return out


GRAD_LEAVES = ("sphere vertices", "light intensity", "sphere diffuse",
               "camera position")
GRAD_RTOL = 1e-4  # kernels vs plain queries: same torch code, index_add order
GRAD_L2_MAX = 0.05  # card vs CPU: ulp-level picks may flip a few lanes


def slice_leaves(scene):
    """The tensors of GRAD_LEAVES."""
    return [scene.shapes[0].vertices, scene.area_lights[0].intensity,
            scene.materials[0].diffuse_reflectance.texels,
            scene.camera.position]


def gradient(scene, opts, engine=None, mesh=None):
    """d render(scene).sum() / d GRAD_LEAVES, with both edge samplers;
    through render_sharded over `mesh` when one is given."""
    leaves = slice_leaves(scene)
    for x in leaves:
        x.requires_grad_(True)
    try:
        if mesh is None:
            loss = rtt.render(scene, opts, seed=SEED, engine=engine).sum()
        else:
            loss = render_sharded(scene, opts, seed=SEED, mesh=mesh).sum()
        return [g.detach() for g in torch.autograd.grad(loss, leaves)]
    finally:
        for x in leaves:
            x.requires_grad_(False)


def _pair_split(hit_a, hit_b, live):
    """Share of live pairs whose two sides hit different triangles."""
    n = int(live.sum())
    return float(((hit_a != hit_b) & live).sum()) / max(n, 1), n


# ----------------------------------------------------------------------
# The card against the CPU, decision by decision
# ----------------------------------------------------------------------

REPLAY_L2_MAX = 1e-4  # what remains once every discrete decision is shared


def _decision_points():
    """(module, attribute) of every function whose result is a discrete
    decision of the gradient path: the ray queries (hit ids, blocked), the
    primary-edge pick (edge id) and the secondary-edge picks (cluster,
    candidate, t), the Morton codes that order the primary-edge samples
    and the edge clusters, and the light, triangle and envmap picks."""
    from redner_tpu_torch import edge as edge_mod
    from redner_tpu_torch.core import vecmath as vm_mod
    return [(accel, "intersect"), (accel, "occluded"),
            (edge_mod, "_count_le"), (edge_mod, "_count_lt"),
            (edge_mod, "_morton3"), (vm_mod, "searchsorted_right")]


def _decision_category(name):
    """The trace's row for a decision made by function `name`, from the
    pass that called it."""
    f = sys._getframe(2)
    caller = f.f_code.co_name
    names = []
    while f is not None:
        names.append(f.f_code.co_name)
        f = f.f_back
    if "_sample_primary_edges" in names:
        where = "primary-edge pass"
    elif "secondary_edge_surrogate" in names or "build_edge_table" in names:
        where = "secondary-edge pass"
    else:
        where = "camera paths"
    what = {"intersect": "hit ids", "occluded": "shadow blocked",
            "_count_le": "edge picks (edge id)",
            "_count_lt": "edge picks (cluster, candidate, t)",
            "_morton3": "Morton order keys",
            "searchsorted_right": "light / triangle / envmap picks"}[name]
    if name == "intersect" and where == "camera paths":
        what = "camera-ray hit ids" if caller == "render_sample" \
            else "bounce hit ids"
    elif name == "intersect":
        what = "pair-ray hit ids"
    return f"{where}: {what}"


def _host(out):
    if isinstance(out, torch.Tensor):
        return out.detach().cpu()
    return dataclasses.replace(out, **{
        f.name: getattr(out, f.name).detach().cpu()
        for f in dataclasses.fields(out)})


def _on(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return dataclasses.replace(x, **{f.name: getattr(x, f.name).to(dev)
                                     for f in dataclasses.fields(x)})


def _ids(x):
    return x if isinstance(x, torch.Tensor) else x.tri_id


class Decisions:
    """Records every discrete decision of the code inside the `with` block
    (see _decision_points), in call order, as host copies; with `replay`
    (another run's record) each call returns the replayed decision instead
    of its own (the call still runs, so the kernels still launch)."""

    def __init__(self, replay=None):
        self.log = []
        self.replay = replay

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in _decision_points()]
        for m, n, orig in self.saved:
            setattr(m, n, self._wrap(n, orig))
        return self

    def __exit__(self, *exc):
        for m, n, orig in self.saved:
            setattr(m, n, orig)

    def _wrap(self, name, orig):
        def call(*args, **kwargs):
            out = orig(*args, **kwargs)
            cat = _decision_category(name)
            own = _host(out)
            if self.replay is not None:
                r_cat, r_val = self.replay[len(self.log)]
                _check(r_cat == cat and _ids(r_val).shape == _ids(own).shape,
                       f"replay out of step at decision {len(self.log)}: "
                       f"{cat} vs {r_cat}")
                out = _on(r_val, _ids(out).device)
            self.log.append((cat, own))
            return out
        return call


def decision_differences(a, b):
    """{category: (lanes, lanes that differ)} between two records."""
    _check(len(a) == len(b) and all(x[0] == y[0] for x, y in zip(a, b)),
           f"the two runs made different decision calls ({len(a)} vs "
           f"{len(b)})")
    out = {}
    for (cat, x), (_, y) in zip(a, b):
        n, d = out.get(cat, (0, 0))
        out[cat] = (n + _ids(x).numel(), d + int((_ids(x) != _ids(y)).sum()))
    return out


def trace_card_vs_cpu(opts):
    """The 32x32 gradient on the card against the CPU's (slice scene, seed
    SEED): both runs record every discrete decision (Decisions); the trace
    prints how many lanes differ in each, then runs the card again with
    the CPU's decisions replayed.  What remains must agree to relative L2
    REPLAY_L2_MAX: then the card-vs-CPU difference is those flips."""
    dev = torch.device("cuda")
    with Decisions() as rec_card:
        gc = gradient(make_slice_scene(res=(32, 32), device=dev), opts)
    with Decisions() as rec_cpu:
        gh = gradient(make_slice_scene(res=(32, 32), device="cpu"), opts)
    for name, a, b in zip(GRAD_LEAVES, gc, gh):
        rel = float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30))
        print(f"[grad] 32x32 card vs CPU, d/d {name}: relative L2 {rel:.3e}",
              flush=True)
        _check(rel <= GRAD_L2_MAX, f"card and CPU gradients differ: {name}")
    diffs = decision_differences(rec_card.log, rec_cpu.log)
    print(f"[trace] 32x32 card vs CPU: {len(rec_cpu.log)} decision calls",
          flush=True)
    for cat, (n, d) in diffs.items():
        print(f"[trace] {cat}: {d} of {n} lanes differ", flush=True)
    with Decisions(replay=rec_cpu.log) as rec_replay:
        gr = gradient(make_slice_scene(res=(32, 32), device=dev), opts)
    flips = sum(d for _, d in decision_differences(rec_replay.log,
                                                   rec_cpu.log).values())
    worst = 0.0
    for name, a, b in zip(GRAD_LEAVES, gr, gh):
        rel = float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30))
        worst = max(worst, rel)
        print(f"[trace] card with the CPU's decisions vs CPU, d/d {name}: "
              f"relative L2 {rel:.3e}", flush=True)
    print(f"[trace] the card's own decisions in the replayed run differ on "
          f"{flips} lanes; what remains: relative L2 {worst:.3e} (gate "
          f"{REPLAY_L2_MAX})", flush=True)
    _check(worst <= REPLAY_L2_MAX, "the card-vs-CPU gradient difference is "
           "not the decision flips alone")


def phase_grad(scene, opts, smi_line):
    """The gradient path once with the launch counts zeroed just before and
    read just after; then its checks and times.  Returns (launches, rows
    per edge-pair kind and kernel, gradient ms)."""
    dev = scene.camera.device
    gradient(scene, opts)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    grads = gradient(scene, opts)
    torch.cuda.synchronize()
    launches = dict(ic.LAUNCHES)
    gathers = note_gather("grad")
    print(f"[grad] launches per gradient evaluation (forward + backward): "
          f"{launches}; by the code 32 closest hit + 16 any hit; row "
          f"gathers {gathers}", flush=True)
    _check(all(v > 0 for v in launches.values()),
           f"a kernel did not launch on the gradient path: {launches}")
    _check(all(v > 0 for v in gathers.values()),
           f"a row-gather kernel did not launch on the gradient path: "
           f"{gathers}")
    for name, g in zip(GRAD_LEAVES, grads):
        print(f"[grad] d/d {name}: shape {tuple(g.shape)}, max |g| "
              f"{float(g.abs().max()):.6g}, L2 {float(g.norm()):.6g}",
              flush=True)
        _check(bool(torch.isfinite(g).all()), f"non-finite gradient: {name}")
    _check(float(grads[0].abs().max()) > 0, "the vertex gradient is zero")

    # The edge-pair rays, captured from one gradient evaluation: 12 forward
    # launches; per re-render pass camera C, A, C then the secondary pair
    # batch's first hit C, shadow A, bounce C; then per primary-edge chunk
    # first hit C, shadow A, bounce C.
    cap = capture_launches(lambda: gradient(scene, opts))
    kinds = [k for k, _ in cap]
    print(f"[grad] captured {len(cap)} launches: "
          f"{''.join('C' if k == 'closest_hit' else 'A' for k in kinds)}",
          flush=True)
    pattern = ["closest_hit", "any_hit", "closest_hit"]
    _check(len(cap) == 48 and kinds[15:18] == pattern
           and kinds[36:39] == pattern and kinds[42] == "closest_hit",
           "launch order differs from the code's; cannot locate the pairs")
    sec, prim, prim_minus = cap[15][1], cap[36][1], cap[42][1]
    fs = rtt.flatten_scene(scene)
    with torch.no_grad():
        hit = lambda rb: ic.finish_closest(
            fs, rb, *ic.closest_hit(fs.layout, rb)).tri_id
        h = hit(sec)
        P = sec.n // 2
        live = torch.zeros(sec.n, dtype=torch.bool, device=dev)
        if sec.perm is None:
            live = sec.live
        else:
            live[sec.perm] = sec.live
        split_s, n_s = _pair_split(h[:P], h[P:], live[:P] & live[P:])
        split_p, n_p = _pair_split(hit(prim), hit(prim_minus),
                                   prim.live & prim_minus.live)
    print(f"[grad] straddle share: secondary pairs {split_s:.6f} of {n_s} "
          f"live pairs; primary-edge pairs (chunks 0 and 2) {split_p:.6f} of "
          f"{n_p}", flush=True)
    print(f"[grad] each kernel per launch on the edge-pair rays, on "
          f"{smi_line}:", flush=True)
    rows = {}
    for kind_name, idx in (("secondary", (15, 16, 17)),
                           ("primary", (36, 37, 38))):
        for i, role in zip(idx, ("first hit", "shadow", "bounce")):
            kind, rb = cap[i]
            rows[f"{kind_name} {role}"] = dict(
                kind=kind, **measure_launch(f"{kind_name}-edge pairs {role}",
                                            kind, fs, rb))

    # Gradient through the kernels against the plain queries on the card.
    s64 = make_slice_scene(res=(64, 64), device=dev)
    gk, gp = gradient(s64, opts), gradient(s64, opts, engine="plain")
    for name, a, b in zip(GRAD_LEAVES, gk, gp):
        tol = GRAD_RTOL * b.abs() + 1e-6 * float(b.abs().max())
        bad = int(((a - b).abs() > tol).sum())
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        print(f"[grad] 64x64 kernels vs plain, d/d {name}: {bad}/{b.numel()} "
              f"entries outside rtol {GRAD_RTOL}, atol 1e-6 x max; relative "
              f"L2 {rel:.3e}", flush=True)
        _check(bad == 0, f"gradient via kernels differs from plain: {name}")

    # The card against the CPU, traced decision by decision.
    trace_card_vs_cpu(opts)

    # Times.
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gradient(scene, opts)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    grad_ms = statistics.median(walls)
    print(f"[grad] fwd+bwd 256x256 4spp 1 bounce: median {grad_ms:.3f} ms of "
          f"{len(walls)} (all: {', '.join(f'{w:.2f}' for w in walls)}); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
          f"{smi_line}", flush=True)
    profile_run(f"one gradient evaluation ({smi_line})",
                lambda: gradient(scene, opts))
    return launches, rows, grad_ms


ENVTEX_LEAVES = ("sphere vertices", "sphere diffuse texels",
                 "envmap texels", "light intensity")


def envtex_leaves(scene):
    """The tensors of ENVTEX_LEAVES."""
    return [scene.shapes[0].vertices,
            scene.materials[0].diffuse_reflectance.texels,
            scene.envmap.values.texels, scene.area_lights[0].intensity]


def envtex_gradient(scene, opts, engine=None):
    """d render(scene).sum() / d ENVTEX_LEAVES, with both edge samplers."""
    leaves = envtex_leaves(scene)
    for x in leaves:
        x.requires_grad_(True)
    try:
        loss = rtt.render(scene, opts, seed=SEED, engine=engine).sum()
        return [g.detach() for g in torch.autograd.grad(loss, leaves)]
    finally:
        for x in leaves:
            x.requires_grad_(False)


def phase_envtex(opts, smi_line):
    """The textured, envmap-lit path: forward and gradient launches, the
    image and background checks, the any-hit kernel on the forward's shadow
    batch (envmap lanes at tmax = inf), card against CPU, kernels against
    plain queries, times and a profile.  Returns (forward launches,
    gradient launches, shadow-batch row, forward ms, gradient ms)."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lap = _Lap(t0)
    scene = make_envtex_scene(device=dev)
    fs = rtt.flatten_scene(scene)
    _check(fs.num_triangles == 15752 and fs.has_envmap
           and fs.mat_bank is not None,
           "envtex scene: want 15752 triangles, an envmap and a bank")
    print(f"[envtex] scene: {fs.num_triangles} triangles; bank "
          f"{fs.mat_bank.flat.shape[0]} texels x {fs.mat_bank.channels} "
          f"channels, {fs.mat_bank.Lmax} levels, stacks at "
          f"{fs.mat_bank_pos}; envmap {tuple(scene.envmap.values.texels.shape)}"
          f" ({fs.envmap.ptex.num_levels} levels); light pmf "
          f"{[round(float(x), 6) for x in fs.light_pmf]}; built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # The forward, with the launch counts zeroed just before.
    with torch.no_grad():
        rtt.render_image(scene, opts, seed=SEED)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        img = rtt.render_image(scene, opts, seed=SEED)
        torch.cuda.synchronize()
        fwd_launches = dict(ic.LAUNCHES)
        fwd_gathers = note_gather("envtex.forward")
    print(f"[envtex] forward launches: {fwd_launches}; row gathers "
          f"{fwd_gathers}", flush=True)
    _check(fwd_launches == {"closest_hit": 8, "any_hit": 4},
           f"envtex forward launches {fwd_launches}, want 8 + 4")
    _check(tuple(img.shape) == (256, 256, 3), f"image shape {img.shape}")
    _check(bool(torch.isfinite(img).all()), "envtex image has non-finite values")
    _check(float(img.max()) > 0, "envtex image is black")

    # Background: the envmap's camera-ray emission is the only difference
    # between the render and one with the envmap hidden from the camera.
    hidden = dataclasses.replace(scene, envmap=dataclasses.replace(
        scene.envmap, directly_visible=False))
    with torch.no_grad():
        bg = (img - rtt.render_image(hidden, opts, seed=SEED)).amax(dim=-1)
    env = scene.envmap.values.texels
    share = float((bg > 0).float().mean())
    top = bg[:16]  # the rows above the sphere and the floor
    print(f"[envtex] 256x256 4spp: mean {float(img.mean()):.6f} max "
          f"{float(img.max()):.4f}; the envmap shows on {share:.4f} of the "
          f"pixels; top 16 rows: min {float(top.min()):.4f} max "
          f"{float(top.max()):.4f} (envmap texels {float(env.min()):.4f}-"
          f"{float(env.max()):.4f})", flush=True)
    _check(0.05 < share < 0.95, f"envmap shows on {share} of the pixels")
    _check(float(top.min()) >= float(env.min()) * 0.99 - 1e-6
           and float(top.max()) <= float(env.max()) * 1.01,
           "the top rows are not the envmap's radiance")

    # The any-hit kernel on the forward's shadow batches: envmap lanes have
    # tmax = inf.
    with torch.no_grad():
        cap = capture_launches(lambda: rtt.render_image(scene, opts,
                                                        seed=SEED))
    shadow = [rb for kind, rb in cap if kind == "any_hit"]
    _check(len(shadow) == 4, f"captured {len(shadow)} any-hit launches")
    for i, rb in enumerate(shadow):
        with torch.no_grad():
            kout = ic.any_hit(fs.layout, rb)
            pout, _ = plain.anyhit_plain(fs.layout.Tc, rb)
        torch.cuda.synchronize()
        bad = int(((kout != 0) != pout).sum())
        n_inf = int((torch.isinf(rb.tmax[: rb.n]) & rb.live).sum())
        print(f"[envtex] shadow batch {i}: {rb.n} rays, {int(rb.live.sum())} "
              f"live, {n_inf} with tmax = inf (envmap), {int(pout.sum())} "
              f"blocked; {bad} lanes differ from anyhit_plain", flush=True)
        _check(n_inf > 0, "no envmap shadow ray in the batch")
        _check(bad == 0, f"shadow batch {i}: {bad} lanes differ")
    shadow_row = measure_launch("envtex shadow batch 0", "any_hit", fs,
                                shadow[0])

    lap("envtex forward checks and shadow batches")
    # The gradient, with the launch counts zeroed just before.
    envtex_gradient(scene, opts)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    grads = envtex_gradient(scene, opts)
    torch.cuda.synchronize()
    grad_launches = dict(ic.LAUNCHES)
    grad_gathers = note_gather("envtex.grad")
    print(f"[envtex] launches per gradient evaluation: {grad_launches}; "
          f"row gathers {grad_gathers}", flush=True)
    _check(grad_launches == {"closest_hit": 32, "any_hit": 16},
           f"envtex gradient launches {grad_launches}, want 32 + 16")
    for name, g in zip(ENVTEX_LEAVES, grads):
        print(f"[envtex] d/d {name}: shape {tuple(g.shape)}, max |g| "
              f"{float(g.abs().max()):.6g}, L2 {float(g.norm()):.6g}",
              flush=True)
        _check(bool(torch.isfinite(g).all()), f"non-finite gradient: {name}")
        _check(float(g.abs().max()) > 0, f"zero gradient: {name}")

    lap("envtex gradient launches")
    # Card against CPU (32x32), kernels against plain queries (64x64).
    small = dict(res=(32, 32))
    with torch.no_grad():
        a = rtt.render_image(make_envtex_scene(device=dev, **small), opts,
                             seed=SEED).cpu()
        b = rtt.render_image(make_envtex_scene(device="cpu", **small), opts,
                             seed=SEED)
    close = torch.isclose(a, b, rtol=1e-4, atol=1e-6 * float(b.max())).all(-1)
    n_diff = int((~close).sum())
    print(f"[envtex] 32x32 card vs CPU: {n_diff}/{close.numel()} pixels "
          f"differ (rtol 1e-4)", flush=True)
    _check(n_diff <= 0.01 * close.numel(), "envtex card and CPU renders differ")
    gc = envtex_gradient(make_envtex_scene(device=dev, **small), opts)
    gh = envtex_gradient(make_envtex_scene(device="cpu", **small), opts)
    for name, x, y in zip(ENVTEX_LEAVES, gc, gh):
        rel = float((x.cpu() - y).norm() / y.norm().clamp_min(1e-30))
        print(f"[envtex] 32x32 card vs CPU, d/d {name}: relative L2 "
              f"{rel:.3e}", flush=True)
        _check(rel <= GRAD_L2_MAX, f"envtex card and CPU gradients differ: "
               f"{name}")
    lap("envtex card vs CPU")
    s64 = make_envtex_scene(device=dev, res=(64, 64))
    gk = envtex_gradient(s64, opts)
    gp = envtex_gradient(s64, opts, engine="plain")
    for name, x, y in zip(ENVTEX_LEAVES, gk, gp):
        tol = GRAD_RTOL * y.abs() + 1e-6 * float(y.abs().max())
        bad = int(((x - y).abs() > tol).sum())
        rel = float((x - y).norm() / y.norm().clamp_min(1e-30))
        print(f"[envtex] 64x64 kernels vs plain, d/d {name}: {bad}/"
              f"{y.numel()} entries outside rtol {GRAD_RTOL}, atol 1e-6 x "
              f"max; relative L2 {rel:.3e}", flush=True)
        _check(bad == 0, f"envtex gradient via kernels differs: {name}")

    lap("envtex kernels vs plain")
    # Times, on the card named by smi_line.
    walls = []
    with torch.no_grad():
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rtt.render_image(scene, opts, seed=SEED)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
    fwd_ms = statistics.median(walls)
    print(f"[envtex] forward 256x256 4spp 1 bounce: median {fwd_ms:.3f} ms "
          f"of 5 (all: {', '.join(f'{w:.2f}' for w in walls)})", flush=True)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        envtex_gradient(scene, opts)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    grad_ms = statistics.median(walls)
    print(f"[envtex] fwd+bwd 256x256 4spp 1 bounce: median {grad_ms:.3f} ms "
          f"of 3 (all: {', '.join(f'{w:.2f}' for w in walls)}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; {smi_line}",
          flush=True)
    lap("envtex times")
    profile_run(f"envtex: one gradient evaluation ({smi_line})",
                lambda: envtex_gradient(scene, opts))
    return fwd_launches, grad_launches, shadow_row, fwd_ms, grad_ms


# ----------------------------------------------------------------------
# The aov phase: the G-buffer, deferred, path-tracing and screen-gradient
# renders of the user utilities
# ----------------------------------------------------------------------

AOV_RENDERS = ("g_buffer", "deferred", "pathtracing", "screen_gradient")
AOV_CHANNELS = tuple(rtt.Channels)  # all 16: C = 47
AOV_ID_CHANNELS = (rtt.Channels.shape_id, rtt.Channels.triangle_id,
                   rtt.Channels.material_id)
AOV_LEAVES = {
    "g_buffer": ("sphere vertices", "sphere diffuse texels",
                 "sphere generic texels", "camera position"),
    "deferred": ("sphere vertices", "sphere diffuse texels",
                 "point light position"),
    "pathtracing": ("sphere vertices", "sphere diffuse texels",
                    "light intensity"),
}
POINT_LIGHT = [0.5, 2.0, -2.0]
SCREEN_OPTS = dict(num_samples=4, max_bounces=1,
                   sampler_type=rtt.SamplerType.sobol)
IMAGE_AGREE_MIN = 0.99  # card vs CPU: float pixels within rtol 1e-4
ID_AGREE_MIN = 0.999  # card vs CPU: id pixels equal


def deferred_lights(point_position):
    """The four deferred light kinds; the point light at point_position."""
    return [
        rtt.AmbientLight([0.03, 0.03, 0.04]),
        rtt.PointLight(point_position, [40.0, 38.0, 34.0]),
        rtt.DirectionalLight([0.4, -1.0, 0.6], [0.6, 0.6, 0.7]),
        # The spot cone opens along spot_direction from the lit point
        # toward the light (redner_tpu's convention): a spot at (-1, 3, -3)
        # aimed at the origin.
        rtt.SpotLight([-1.0, 3.0, -3.0], [-0.2294, 0.6882, -0.6882], 6.0,
                      [25.0, 25.0, 25.0]),
    ]


def gbuffer_leaves(scene):
    """The tensors of AOV_LEAVES["g_buffer"]."""
    m0 = scene.materials[0]
    return [scene.shapes[0].vertices, m0.diffuse_reflectance.texels,
            m0.generic_texture.texels, scene.camera.position]


def aov_render(name, scene, engine=None, grad=False):
    """One of AOV_RENDERS on scene (a make_envtex_scene(generic=16) scene)
    -> (output, gradients of sum(output * w) w.r.t. AOV_LEAVES[name] or
    None).  w weights the channels 0.5..1.5, so the loss reads every
    channel.

    g_buffer: render_g_buffer with all 16 channels (Sobol, 1 spp, 0
    bounces); deferred: render_deferred with the four light kinds, alpha
    and aa_samples=2; pathtracing: render_pathtracing at 4 spp, 1 bounce,
    Sobol; screen_gradient: screen_gradient_image at 4 spp, 1 bounce,
    Sobol, with primary edges (forward only)."""
    m0 = scene.materials[0]
    if name == "screen_gradient":
        opts = rtt.RenderOptions(**SCREEN_OPTS)
        return rtt.screen_gradient_image(scene, opts, seed=SEED,
                                         engine=engine), None
    if name == "g_buffer":
        leaves = gbuffer_leaves(scene)
        fn = lambda: rtt.render_g_buffer(scene, AOV_CHANNELS, seed=SEED,
                                         engine=engine)
    elif name == "deferred":
        point = torch.tensor(POINT_LIGHT, device=scene.camera.device)
        leaves = [scene.shapes[0].vertices, m0.diffuse_reflectance.texels,
                  point]
        fn = lambda: rtt.render_deferred(scene, deferred_lights(point),
                                         alpha=True, aa_samples=2, seed=SEED,
                                         engine=engine)
    else:
        leaves = [scene.shapes[0].vertices, m0.diffuse_reflectance.texels,
                  scene.area_lights[0].intensity]
        fn = lambda: rtt.render_pathtracing(scene, max_bounces=1,
                                            num_samples=4, seed=SEED,
                                            engine=engine)
    if not grad:
        with torch.no_grad():
            return fn(), None
    for x in leaves:
        x.requires_grad_(True)
    try:
        img = fn()
        w = torch.linspace(0.5, 1.5, img.shape[-1], device=img.device)
        grads = torch.autograd.grad(torch.sum(img * w), leaves)
        return img.detach(), [g.detach() for g in grads]
    finally:
        for x in leaves:
            x.requires_grad_(False)


def _id_columns(name, n_cols):
    """Boolean mask of the id columns of render `name`'s output."""
    ids = torch.zeros(n_cols, dtype=torch.bool)
    if name == "g_buffer":
        ci = rtt.ChannelInfo(AOV_CHANNELS)
        for ch in AOV_ID_CHANNELS:
            ids[ci.offset_of(ch)] = True
    return ids


def image_agreement(name, a, b):
    """(share of pixels whose float columns agree at rtol 1e-4, atol 1e-6 x
    max; share whose id columns are equal) between outputs a and b."""
    a, b = a.cpu(), b.cpu()
    ids = _id_columns(name, a.shape[-1])
    fa, fb = a[..., ~ids], b[..., ~ids]
    close = torch.isclose(fa, fb, rtol=1e-4,
                          atol=1e-6 * float(fb.abs().max())).flatten(2).all(-1)
    same = (a[..., ids] == b[..., ids]).all(-1) if ids.any() else \
        torch.ones(a.shape[:2], dtype=torch.bool)
    return float(close.float().mean()), float(same.float().mean())


def check_batches(label, fs, cap):
    """Each captured batch through the kernel and its plain version:
    closest hit ids on >= AGREE_MIN of the lanes, any hit on all.  Returns
    (batches, lanes compared, lanes that differ)."""
    lanes = bad_all = 0
    for i, (kind, rb) in enumerate(cap):
        with torch.no_grad():
            if kind == "closest_hit":
                kout = ic.closest_hit(fs.layout, rb)[1].to(torch.int64)
                bad = int((kout != plain.closest_plain(fs.layout.Tc,
                                                       rb)[1]).sum())
                _check(bad <= (1 - AGREE_MIN) * rb.n,
                       f"{label} batch {i}: {bad} closest-hit lanes differ")
            else:
                kout = ic.any_hit(fs.layout, rb) != 0
                bad = int((kout != plain.anyhit_plain(fs.layout.Tc,
                                                      rb)[0]).sum())
                _check(bad == 0, f"{label} batch {i}: {bad} any-hit lanes "
                       "differ")
        lanes += rb.n
        bad_all += bad
    return len(cap), lanes, bad_all


def _wall_ms(run, reps=3):
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), walls


def phase_aov(smi_line):
    """The G-buffer, deferred, path-tracing and screen-gradient renders of
    the user utilities on the envtex scene with a 512x512x16 generic
    texture and a vertex-coloured floor: launches per forward and per
    gradient, kernels against their plain versions on the captured batches
    (the deferred 262,144-ray batch timed against its bound), images
    through the kernels against the plain queries (64x64), the card
    against the CPU (32x32), times, peak memory and a profile.  Returns
    {render: row} and the 262,144-ray batch's row."""
    dev = torch.device("cuda")
    lap = _Lap(time.perf_counter())
    scene = make_envtex_scene(device=dev, generic=16)
    fs = rtt.flatten_scene(scene)
    _check(fs.num_triangles == 15752 and fs.mat_generic[0] is not None,
           "aov scene: want 15752 triangles and a generic texture")
    C = rtt.ChannelInfo(AOV_CHANNELS).num_total_dimensions
    print(f"[aov] scene: envtex + generic texture "
          f"{tuple(scene.materials[0].generic_texture.texels.shape)} on the "
          f"sphere, vertex colours on the floor; G-buffer channels C = {C}",
          flush=True)
    _check(C == 47, f"all 16 channels give C = {C}, want 47")
    # Each render once with the launch counts zeroed just before and read
    # just after, its kernel launches captured on the way (the recorder
    # calls the counted wrappers).  The screen gradient (seconds a call)
    # has no warm-up of its own: its counted call warms it up for the
    # timed calls below.
    rows, caps = {}, {}
    for name in AOV_RENDERS:
        grad = name != "screen_gradient"
        if grad:
            aov_render(name, scene, grad=True)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        out = []
        caps[name] = capture_launches(
            lambda: out.append(aov_render(name, scene)[0]))
        out = out[0]
        row = {"launches": dict(ic.LAUNCHES)}
        if grad:
            reset_launches()
            grads = []
            cap = capture_launches(
                lambda: grads.extend(aov_render(name, scene, grad=True)[1]))
            row["launches_per_gradient"] = dict(ic.LAUNCHES)
            if name != "pathtracing":  # its forward's batches are enough
                caps[name] = cap
            for leaf, g in zip(AOV_LEAVES[name], grads):
                _check(bool(torch.isfinite(g).all()),
                       f"{name}: non-finite gradient w.r.t. {leaf}")
                _check(float(g.abs().max()) > 0,
                       f"{name}: zero gradient w.r.t. {leaf}")
        radiance = name in ("pathtracing", "screen_gradient")
        for key in ("launches", "launches_per_gradient"):
            if key in row:
                got = row[key]
                _check(got["closest_hit"] > 0 and
                       (got["any_hit"] > 0) == radiance,
                       f"{name} {key}: {got} (any hit only with radiance)")
        _check(bool(torch.isfinite(out).all()) and float(out.abs().max()) > 0,
               f"{name}: output not finite or all zero")
        row["shape"] = tuple(out.shape)
        print(f"[aov] {name}: output {tuple(out.shape)}, launches per "
              f"forward {row['launches']}"
              + (f", per gradient {row['launches_per_gradient']}"
                 if grad else ""), flush=True)
        rows[name] = row
    _check(rows["deferred"].pop("shape") == (256, 256, 4)
           and rows["deferred"]["launches"] == {"closest_hit": 1,
                                                "any_hit": 0},
           "deferred: want a 256x256x4 image from one 512x512 pass")
    _check(rows["g_buffer"].pop("shape") == (256, 256, 47),
           "g_buffer: want a 256x256x47 image")
    for name in ("pathtracing", "screen_gradient"):
        rows[name].pop("shape")
    lap("aov launches")

    # Kernels against plain versions on the captured batches: the
    # gradients' of the G-buffer and the deferred render, the path tracer's
    # forward, and the screen gradient's first sample and last edge chunk.
    cap = caps["deferred"]
    n_max = max(rb.n for _, rb in cap)
    big = [rb for _, rb in cap if rb.n == n_max]
    _check(n_max == 512 * 512 and len(big) == 2,
           f"deferred: {len(big)} batches of {n_max} rays, want 2 of "
           "262,144 (forward and re-render)")
    caps["screen_gradient"] = (caps["screen_gradient"][:3]
                               + caps["screen_gradient"][-3:])
    for name, c in caps.items():
        n, lanes, bad = check_batches(name, fs, c)
        print(f"[aov] {name}: {n} batches, {lanes} lanes against the plain "
              f"versions, {bad} differ", flush=True)
    print(f"[aov] the deferred 512x512 G-buffer batch on {smi_line}:",
          flush=True)
    big_row = measure_launch("deferred 262,144-ray batch", "closest_hit",
                             fs, big[0])
    lap("aov batches")

    # Images through the kernels against the plain queries (64x64), the
    # card against the CPU (32x32).
    s64 = make_envtex_scene(device=dev, generic=16, res=(64, 64))
    sc = make_envtex_scene(device=dev, generic=16, res=(32, 32))
    sh = make_envtex_scene(device="cpu", generic=16, res=(32, 32))
    for name in AOV_RENDERS:
        t0 = time.perf_counter()
        k, _ = aov_render(name, s64)
        p, _ = aov_render(name, s64, engine="plain")
        f_ok, id_ok = image_agreement(name, k, p)
        print(f"[aov] 64x64 {name} kernels vs plain: {f_ok:.6f} of the "
              f"pixels within rtol 1e-4, ids equal on {id_ok:.6f}",
              flush=True)
        _check(f_ok >= PIXEL_AGREE_MIN and id_ok >= PIXEL_AGREE_MIN,
               f"{name}: the kernels' image differs from the plain queries'")
        grad = name != "screen_gradient"
        a, ga = aov_render(name, sc, grad=grad)
        b, gb = aov_render(name, sh, grad=grad)
        if grad:
            f_ok, id_ok = image_agreement(name, a, b)
            print(f"[aov] 32x32 {name} card vs CPU: {f_ok:.6f} of the pixels "
                  f"within rtol 1e-4, ids equal on {id_ok:.6f}", flush=True)
            _check(f_ok >= IMAGE_AGREE_MIN and id_ok >= ID_AGREE_MIN,
                   f"{name}: card and CPU images differ")
            pairs = zip(AOV_LEAVES[name], ga, gb)
        else:  # a derivative image: held like a gradient
            pairs = [("screen gradient image", a, b)]
        for leaf, x, y in pairs:
            rel = float((x.cpu() - y).norm() / y.norm().clamp_min(1e-30))
            print(f"[aov] 32x32 {name} card vs CPU, {leaf}: relative L2 "
                  f"{rel:.3e}", flush=True)
            _check(rel <= GRAD_L2_MAX, f"{name}: card and CPU differ ({leaf})")
        print(f"[aov] {name}: 64x64 and 32x32 checks took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    lap("aov kernels vs plain, card vs CPU")

    # Times and peak memory, on the card named by smi_line.
    for name in AOV_RENDERS:
        row = rows[name]
        row["forward_ms"], walls = _wall_ms(
            lambda: aov_render(name, scene),
            reps=2 if name == "screen_gradient" else 3)
        msg = (f"[aov] {name}: forward median {row['forward_ms']:.3f} ms "
               f"(all: {', '.join(f'{w:.2f}' for w in walls)})")
        if name == "screen_gradient":
            print(f"{msg}; {smi_line}", flush=True)
            continue
        torch.cuda.reset_peak_memory_stats()
        row["gradient_ms"], walls = _wall_ms(
            lambda: aov_render(name, scene, grad=True))
        row["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        msg += (f"; fwd+bwd median {row['gradient_ms']:.3f} ms (all: "
                f"{', '.join(f'{w:.2f}' for w in walls)}), peak memory "
                f"{row['peak_mib']:.1f} MiB")
        print(f"{msg}; {smi_line}", flush=True)
    lap("aov times")
    lanes = torch.arange(65536, device=dev)
    for st in (rtt.SamplerType.sobol, rtt.SamplerType.independent):
        run = lambda: sampler_mod.draw(st, SEED, lanes, 3, 9, 4)
        run()  # warm-up (the Sobol table's bit planes reach the card once)
        profile_run(f"one {st.name} draw of 4 dims at 65,536 lanes", run,
                    top=3)
    profile_run(f"aov: one G-buffer gradient evaluation ({smi_line})",
                lambda: aov_render("g_buffer", scene, grad=True))
    lap("aov profile")
    return rows, big_row


# ----------------------------------------------------------------------
# The files and cameras phases: the envtex scene written to disk, loaded
# back through the Mitsuba loader, and rendered under every camera type
# ----------------------------------------------------------------------

FILE_JITTER = 2.5e-7  # split-vertex jitter: with %.6g, inside the weld eps
DISTORTION = [0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 0.001, 0.0]  # k1, p1
CAMERAS = ("orthographic", "fisheye", "panorama", "distorted")


def write_files_scene(root, res=(256, 256), theta=64, phi=128, tex=512,
                      env=(256, 512), seed=SEED):
    """Write the envtex scene under `root` as a user would ship it: the
    sphere as an OBJ whose faces each have their own three vertices
    (positions jittered by up to FILE_JITTER and written at %.6g, so the
    auto weld has work), the same sphere unsplit (whole.obj), the diffuse
    texture and the envmap as EXR, and a Mitsuba XML: a sensor with a
    toWorld lookat and a res film, the sphere's bitmap-textured diffuse
    bsdf, the floor and the light as rectangles, the envmap emitter.  The
    loader reads no roughness texture and no normal map, so the scene has
    neither.  Returns the XML's path."""
    arr = envtex_arrays(tex, env, seed)
    rtt.imwrite(arr["diffuse"], os.path.join(root, "diffuse.exr"))
    rtt.imwrite(arr["envmap"], os.path.join(root, "envmap.exr"))
    v, f, uv, n = (x.numpy() for x in rtt.generate_sphere(theta, phi,
                                                          device="cpu"))
    corners = f.reshape(-1)
    jitter = np.random.default_rng(seed).uniform(
        -FILE_JITTER, FILE_JITTER, (corners.size, 3))
    lines = []
    for p, t, m in zip(v[corners] + jitter, uv[corners], n[corners]):
        lines.append(f"v {p[0]:.6g} {p[1]:.6g} {p[2]:.6g}\n"
                     f"vt {t[0]:.6g} {1.0 - t[1]:.6g}\n"
                     f"vn {m[0]:.6g} {m[1]:.6g} {m[2]:.6g}\n")
    for k in range(f.shape[0]):
        a = 3 * k + 1
        lines.append(f"f {a}/{a}/{a} {a + 1}/{a + 1}/{a + 1} "
                     f"{a + 2}/{a + 2}/{a + 2}\n")
    with open(os.path.join(root, "sphere.obj"), "w") as out:
        out.writelines(lines)
    with open(os.path.join(root, "whole.obj"), "w") as out:
        out.writelines(f"v {p[0]:.6g} {p[1]:.6g} {p[2]:.6g}\n" for p in v)
        out.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f)
    xml = os.path.join(root, "scene.xml")
    with open(xml, "w") as out:
        out.write(f"""<scene version="0.5.0">
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld">
      <lookat origin="0, 1, -4.5" target="0, -0.2, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="{res[1]}"/>
      <integer name="height" value="{res[0]}"/>
    </film>
  </sensor>
  <bsdf type="diffuse" id="textured">
    <texture type="bitmap" name="reflectance">
      <string name="filename" value="diffuse.exr"/>
    </texture>
  </bsdf>
  <bsdf type="diffuse" id="gray">
    <rgb name="reflectance" value="0.4, 0.4, 0.4"/>
  </bsdf>
  <shape type="obj">
    <string name="filename" value="sphere.obj"/>
    <ref id="textured"/>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld">
      <scale value="4"/><rotate x="1" y="0" z="0" angle="-90"/>
      <translate x="0" y="-1" z="0"/>
    </transform>
    <ref id="gray"/>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld">
      <lookat origin="0, 4, -1" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <emitter type="area"><rgb name="radiance" value="20, 20, 20"/></emitter>
  </shape>
  <emitter type="envmap">
    <string name="filename" value="envmap.exr"/>
  </emitter>
</scene>
""")
    return xml


def edge_counts(shape, device):
    """(edges, boundary edges) of one shape's welded edge table."""
    from redner_tpu_torch.edge import build_edges

    cam = rtt.make_camera(position=[0, 0, -5], look_at=[0, 0, 0], up=[0, 1, 0],
                          fov=45.0, resolution=(4, 4), device=device)
    mat = rtt.make_material(diffuse_reflectance=[0.5] * 3, device=device)
    e = build_edges(rtt.flatten_scene(rtt.make_scene(cam, [shape], [mat])))
    return int(e.valid.sum()), int((e.valid & (e.f1 < 0)).sum())


def with_camera(scene, name, res=None):
    """The loaded scene under camera `name` (CAMERAS, or "perspective" for
    its own), from the same cam_to_world, at resolution res."""
    c = scene.camera
    res = res or c.resolution
    if name == "perspective":
        return dataclasses.replace(scene, camera=dataclasses.replace(
            c, resolution=res))
    kw = {"orthographic": dict(camera_type=rtt.CameraType.orthographic,
                               intrinsic_mat=np.diag([0.3, 0.3, 1.0])),
          "fisheye": dict(camera_type=rtt.CameraType.fisheye),
          "panorama": dict(camera_type=rtt.CameraType.panorama),
          "distorted": dict(intrinsic_mat=c.intrinsic_mat.detach().clone(),
                            distortion_params=DISTORTION)}[name]
    cam = rtt.make_camera(cam_to_world=c.cam_to_world.detach().clone(),
                          resolution=res, device=c.device, **kw)
    return dataclasses.replace(scene, camera=cam)


def camera_leaves(scene):
    """(label, tensor) of the loaded scene's leaves that its camera uses:
    the sphere's vertices, cam_to_world, intrinsic_mat (perspective and
    orthographic), distortion_params (distorted), the diffuse texels and
    the envmap texels."""
    c = scene.camera
    out = [("sphere vertices", scene.shapes[0].vertices),
           ("cam_to_world", c.cam_to_world)]
    if c.camera_type in (rtt.CameraType.perspective,
                         rtt.CameraType.orthographic):
        out.append(("intrinsic_mat", c.intrinsic_mat))
    if c.has_distortion:
        out.append(("distortion_params", c.distortion_params))
    return out + [("diffuse texels",
                   scene.materials[0].diffuse_reflectance.texels),
                  ("envmap texels", scene.envmap.values.texels)]


def leaf_gradient(scene, opts, engine=None):
    """d render(scene).sum() / d camera_leaves(scene), both edge samplers."""
    leaves = [x for _, x in camera_leaves(scene)]
    for x in leaves:
        x.requires_grad_(True)
    try:
        loss = rtt.render(scene, opts, seed=SEED, engine=engine).sum()
        return [g.detach() for g in torch.autograd.grad(loss, leaves)]
    finally:
        for x in leaves:
            x.requires_grad_(False)


def check_scene_paths(tag, camera, scene, scene_cpu, opts, smi_line, reps):
    """One scene (the loaded scene under `camera`, see with_camera) and its
    forward and gradient: launches (counted), kernels
    against plain versions on every captured batch, finite outputs, the
    image through the kernels against the plain queries (64x64), the card
    against the CPU (32x32: image and every leaf's gradient), fwd+bwd wall
    (median of `reps`, after a warm-up when reps > 1) and peak memory.
    Returns (row, the forward's captured batches, FlatScene)."""
    fs = rtt.flatten_scene(scene)
    with torch.no_grad():
        reset_launches()
        out = []
        fwd_cap = capture_launches(
            lambda: out.append(rtt.render_image(scene, opts, seed=SEED)))
        row = {"launches": dict(ic.LAUNCHES)}
    img = out[0]
    reset_launches()
    grads = []
    grad_cap = capture_launches(
        lambda: grads.extend(leaf_gradient(scene, opts)))
    row["launches_per_gradient"] = dict(ic.LAUNCHES)
    print(f"[{tag}] launches per forward {row['launches']}, per gradient "
          f"{row['launches_per_gradient']}", flush=True)
    _check(all(v > 0 for v in row["launches"].values())
           and all(v > 0 for v in row["launches_per_gradient"].values()),
           f"{tag}: a kernel did not launch: {row}")
    _check(bool(torch.isfinite(img).all()) and float(img.max()) > 0,
           f"{tag}: image not finite or black")
    for (label, _), g in zip(camera_leaves(scene), grads):
        print(f"[{tag}] d/d {label}: shape {tuple(g.shape)}, max |g| "
              f"{float(g.abs().max()):.6g}", flush=True)
        _check(bool(torch.isfinite(g).all()), f"{tag}: non-finite gradient "
               f"w.r.t. {label}")
        _check(float(g.abs().max()) > 0, f"{tag}: zero gradient w.r.t. "
               f"{label}")
    n, lanes, bad = check_batches(tag, fs, fwd_cap + grad_cap)
    print(f"[{tag}] {n} batches, {lanes} lanes against the plain versions, "
          f"{bad} differ", flush=True)

    s64 = with_camera(scene, camera, (64, 64))
    with torch.no_grad():
        k = rtt.render_image(s64, opts, seed=SEED)
        p = rtt.render_image(s64, opts, seed=SEED, engine="plain")
    f_ok, _ = image_agreement(tag, k, p)
    print(f"[{tag}] 64x64 kernels vs plain: {f_ok:.6f} of the pixels within "
          f"rtol 1e-4", flush=True)
    _check(f_ok >= PIXEL_AGREE_MIN, f"{tag}: the kernels' image differs")
    sc = with_camera(scene, camera, (32, 32))
    sh = with_camera(scene_cpu, camera, (32, 32))
    with torch.no_grad():
        a = rtt.render_image(sc, opts, seed=SEED)
        b = rtt.render_image(sh, opts, seed=SEED)
    f_ok, _ = image_agreement(tag, a, b)
    print(f"[{tag}] 32x32 card vs CPU: {f_ok:.6f} of the pixels within rtol "
          f"1e-4", flush=True)
    _check(f_ok >= IMAGE_AGREE_MIN, f"{tag}: card and CPU images differ")
    for (label, _), x, y in zip(camera_leaves(sc), leaf_gradient(sc, opts),
                                leaf_gradient(sh, opts)):
        rel = float((x.cpu() - y).norm() / y.norm().clamp_min(1e-30))
        print(f"[{tag}] 32x32 card vs CPU, d/d {label}: relative L2 "
              f"{rel:.3e}", flush=True)
        _check(rel <= GRAD_L2_MAX, f"{tag}: card and CPU gradients differ "
               f"({label})")

    if reps > 1:
        leaf_gradient(scene, opts)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    row["gradient_ms"], walls = _wall_ms(lambda: leaf_gradient(scene, opts),
                                         reps=reps)
    row["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    print(f"[{tag}] fwd+bwd {scene.camera.height}x{scene.camera.width} "
          f"4spp 1 bounce: median {row['gradient_ms']:.3f} ms of {reps} "
          f"(all: {', '.join(f'{w:.2f}' for w in walls)}); peak memory "
          f"{row['peak_mib']:.1f} MiB; {smi_line}", flush=True)
    return row, fwd_cap, fs


def phase_files(opts, smi_line):
    """The envtex scene from files: written (write_files_scene), loaded with
    rtt.load_mitsuba onto the card and the CPU, the welded sphere's edge
    table against the unsplit mesh's, then check_scene_paths.  Returns
    (row, the loaded card scene, the CPU scene)."""
    import tempfile

    dev = torch.device("cuda")
    lap = _Lap(time.perf_counter())
    with tempfile.TemporaryDirectory() as root:
        xml = write_files_scene(root)
        lap("files written")
        t0 = time.perf_counter()
        scene = rtt.load_mitsuba(xml, device=dev)
        load_s = time.perf_counter() - t0
        scene_cpu = rtt.load_mitsuba(xml, device="cpu")
        whole = rtt.load_obj(os.path.join(root, "whole.obj"),
                             return_objects=True, device=dev)[0]
    sphere = scene.shapes[0]
    fs = rtt.flatten_scene(scene)
    tex = scene.materials[0].diffuse_reflectance.texels
    print(f"[files] loaded in {load_s:.2f} s: {len(scene.shapes)} shapes, "
          f"{fs.num_triangles} triangles, camera cam_to_world (use_look_at "
          f"{scene.camera.use_look_at}), film {scene.camera.resolution}, "
          f"diffuse texture {tuple(tex.shape)}, envmap "
          f"{tuple(scene.envmap.values.texels.shape)}; the Mitsuba "
          f"loader reads no roughness texture and no normal map, so the "
          f"scene has neither", flush=True)
    _check(fs.num_triangles == 15752 and fs.has_envmap
           and scene.camera.resolution == (256, 256)
           and tex.shape == (512, 512, 3), "files scene: want 15752 triangles, an "
           "envmap, a 256x256 film and the 512x512 texture")
    _check(sphere.weld_ids is not None, "the split sphere was not welded")
    moved = int((sphere.vertices[sphere.weld_ids] != sphere.vertices)
                .any(dim=-1).sum())
    split = edge_counts(rtt.make_shape(vertices=sphere.vertices,
                                       indices=sphere.indices,
                                       weld_ids=sphere.weld_ids, device=dev),
                        dev)
    ref = edge_counts(rtt.make_shape(vertices=whole.vertices,
                                     indices=whole.indices,
                                     weld_ids=whole.weld_ids, device=dev),
                      dev)
    print(f"[files] sphere: {sphere.num_vertices} split vertices, {moved} "
          f"keyed on another vertex's position by the weld; edges, boundary "
          f"edges: welded {split}, unsplit mesh {ref}", flush=True)
    _check(moved > 0 and split == ref, "the welded sphere's edge table "
           "differs from the unsplit mesh's")
    lap("files loaded, weld checked")
    row, _, _ = check_scene_paths("files", "perspective", scene, scene_cpu,
                                  opts, smi_line, reps=3)
    row["load_s"] = load_s
    lap("files paths")
    return row, scene, scene_cpu


def phase_cameras(scene, scene_cpu, opts, smi_line):
    """The loaded scene under the orthographic, fisheye, panorama and
    distorted perspective cameras at 256x256: check_scene_paths for each
    (fwd+bwd median of 3 for the fisheye, one call for the others); the
    fisheye's and the panorama's camera-ray batch timed against its bound,
    the fisheye's dead lanes checked as misses.  Returns {camera: row}."""
    rows = {}
    for name in CAMERAS:
        t0 = time.perf_counter()
        row, fwd_cap, fs = check_scene_paths(
            name, name, with_camera(scene, name), scene_cpu, opts, smi_line,
            reps=3 if name == "fisheye" else 1)
        if name in ("fisheye", "panorama"):
            kind, rb = fwd_cap[0]
            _check(kind == "closest_hit", "the first forward batch is not "
                   "the camera rays")
            dead = 1.0 - float(rb.live.float().mean())
            with torch.no_grad():
                best_t, _ = ic.closest_hit(fs.layout, rb)
            misses = bool(torch.isinf(best_t[: rb.n][~rb.live]).all())
            print(f"[{name}] camera-ray batch: {rb.n} rays, dead-lane share "
                  f"{dead:.4f}; dead lanes come back as misses: {misses}",
                  flush=True)
            _check(misses, f"{name}: a dead lane hit something")
            _check((dead > 0.2) == (name == "fisheye"),
                   f"{name}: dead-lane share {dead}")
            row["camera_batch"] = dict(dead_share=dead, **measure_launch(
                f"{name} camera rays", "closest_hit", fs, rb))
        rows[name] = row
        print(f"[timing] cameras {name}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    return rows


# ----------------------------------------------------------------------
# The pyredner-style front end, remat and the replay option
# ----------------------------------------------------------------------

FRONT_PIXEL_MIN = 0.9999  # front end vs functional: pixels at rtol 1e-6
FRONT_L2_MAX = 1e-5  # gradients: float atomics of the index backward only
ADAM_STEPS = 5


def frontend_slice_scene(res=(256, 256), theta=64, phi=128, textures=None):
    """make_slice_scene through redner_tpu_torch.frontend on the default
    device.  textures: envtex_arrays(...) for make_envtex_scene's sphere
    material, floor colours and envmap (the aov scene when it holds a
    generic texture)."""
    cam = pyredner.Camera(position=[0.0, 1.0, -4.5], look_at=[0.0, -0.2, 0.0],
                          up=[0.0, 1.0, 0.0], fov=[45.0], resolution=res)
    v, f, uv, n = pyredner.generate_sphere(theta, phi)
    envmap = floor_colors = None
    if textures is None:
        sphere_mat = pyredner.Material(diffuse_reflectance=[0.5, 0.5, 0.5],
                                       specular_reflectance=[0.2, 0.2, 0.2],
                                       roughness=[0.05])
    else:
        sphere_mat = pyredner.Material(
            diffuse_reflectance=textures["diffuse"],
            specular_reflectance=[0.2, 0.2, 0.2],
            roughness=textures["roughness"],
            generic_texture=textures["generic"],
            normal_map=textures["normal_map"])
        envmap = pyredner.EnvironmentMap(textures["envmap"])
        if textures["generic"] is not None:
            floor_colors = [[0.9, 0.2, 0.2], [0.2, 0.9, 0.2],
                            [0.2, 0.2, 0.9], [0.9, 0.9, 0.2]]
    floor_v = [[-4.0, -1.0, -4.0], [4.0, -1.0, -4.0], [-4.0, -1.0, 4.0],
               [4.0, -1.0, 4.0]]
    objs = [
        pyredner.Object(vertices=v, indices=f, uvs=uv, normals=n,
                        material=sphere_mat),
        pyredner.Object(vertices=floor_v, indices=[[0, 2, 1], [1, 2, 3]],
                        colors=floor_colors,
                        material=pyredner.Material(
                            diffuse_reflectance=[0.4, 0.4, 0.4])),
        pyredner.generate_quad_light(position=[0.0, 4.0, -1.0],
                                     look_at=[0.0, 0.0, 0.0], size=[2.0, 2.0],
                                     intensity=[20.0, 20.0, 20.0]),
    ]
    return pyredner.Scene(camera=cam, objects=objs, envmap=envmap)


def frontend_gradient(fe, **options):
    """pyredner.render(fe, **options).sum() differentiated w.r.t.
    GRAD_LEAVES (the front end's tensors) -> (image, gradients)."""
    leaves = [fe.shapes[0].vertices, fe.area_lights[0].intensity,
              fe.materials[0].diffuse_reflectance.texels, fe.camera.position]
    for x in leaves:
        x.requires_grad_(True)
    try:
        img = pyredner.render(fe, num_samples=4, max_bounces=1, seed=SEED,
                              **options)
        grads = torch.autograd.grad(img.sum(), leaves)
        return img.detach(), [g.detach() for g in grads]
    finally:
        for x in leaves:
            x.requires_grad_(False)


def rel_l2(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def pixel_share(a, b, rtol):
    """Share of pixels whose every channel agrees at rtol (atol 0)."""
    return float(torch.isclose(a, b, rtol=rtol, atol=0.0).all(-1).float()
                 .mean())


def counted(run):
    """run() with the launch counts zeroed just before and read just
    after -> (its result, {kernel: launches})."""
    torch.cuda.synchronize()
    reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, dict(ic.LAUNCHES)


def _check_launches(label, got, want):
    print(f"[frontend] {label} launches {got}; predicted "
          f"{want[0]} closest hit + {want[1]} any hit", flush=True)
    _check(all(v > 0 for v in got.values()),
           f"{label}: a kernel did not launch: {got}")
    _check((got["closest_hit"], got["any_hit"]) == want,
           f"{label}: launches {got}, want {want}")


def frontend_adam(fe, dev, tag, smi_line):
    """Tutorial 01's loop on front-end scene fe: ADAM_STEPS Adam steps on
    the sphere's diffuse toward a target rendered with another diffuse,
    the same seed every step; the diffuse is put back after.  Returns
    (losses, ms per step); the loss must fall."""
    target_fe = frontend_slice_scene()
    target_fe.materials[0].diffuse_reflectance.texels = torch.tensor(
        [0.8, 0.3, 0.2], device=dev)
    with torch.no_grad():
        target = pyredner.render(target_fe, num_samples=4, max_bounces=1,
                                 seed=SEED)
    start = fe.materials[0].diffuse_reflectance.texels
    diffuse = start.clone()
    diffuse.requires_grad_(True)
    fe.materials[0].diffuse_reflectance.texels = diffuse
    adam = torch.optim.Adam([diffuse], lr=0.05)
    losses, step_ms = [], []
    for step in range(ADAM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adam.zero_grad()
        loss = ((pyredner.render(fe, num_samples=4, max_bounces=1, seed=SEED)
                 - target) ** 2).sum()
        loss.backward()
        adam.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach()))
        _check(bool(torch.isfinite(diffuse.grad).all()),
               f"Adam step {step}: non-finite gradient")
        print(f"[{tag}] Adam step {step}: loss {losses[-1]:.6g}, diffuse "
              f"{[round(x, 4) for x in diffuse.detach().tolist()]}, "
              f"{step_ms[-1]:.3f} ms ({smi_line})", flush=True)
    _check(losses[-1] < losses[0], f"the Adam loss did not fall: {losses}")
    fe.materials[0].diffuse_reflectance.texels = start
    return losses, step_ms


def phase_frontend(scene, opts, smi_line):
    """The front end on the slice, its inverse-rendering loop and its
    utilities; then remat on the functional slice gradient, and the
    isect_replay_max_mb option.
    Returns {"frontend" | "replay" | "remat" | "live": row}."""
    lap = _Lap(time.perf_counter())
    dev = scene.camera.device
    fe = frontend_slice_scene()
    _check(rtt.flatten_scene(fe._build()).num_triangles
           == rtt.flatten_scene(scene).num_triangles
           and fe.camera.position.device == dev,
           "the front-end slice differs from make_slice_scene")
    rows = {}

    # The front end against the functional render, and its launches.
    frontend_gradient(fe)  # warm-up
    with torch.no_grad():
        img, fwd = counted(lambda: pyredner.render(
            fe, num_samples=4, max_bounces=1, seed=SEED))
        ref = rtt.render(scene, opts, seed=SEED)
    _check_launches("front-end forward", fwd, (8, 4))
    (fimg, fgrads), grad_l = counted(lambda: frontend_gradient(fe))
    _check_launches("front-end gradient", grad_l, (32, 16))
    share = pixel_share(img, ref, 1e-6)
    print(f"[frontend] pyredner.render vs rtt.render 256x256: {share:.6f} of "
          f"pixels at rtol 1e-6, max |diff| "
          f"{float((img - ref).abs().max()):.3e}; image on {img.device}",
          flush=True)
    _check(img.device == dev and share >= FRONT_PIXEL_MIN,
           f"front-end image: {share} of pixels at rtol 1e-6")
    _check(torch.equal(fimg, img), "the front end's forward differs from "
           "its gradient's forward")
    grads = gradient(scene, opts)
    for name, a, b in zip(GRAD_LEAVES, fgrads, grads):
        r = rel_l2(a, b)
        print(f"[frontend] d/d {name}: relative L2 {r:.3e} against "
              f"rtt.render's", flush=True)
        _check(bool(torch.isfinite(a).all()) and r <= FRONT_L2_MAX,
               f"front-end gradient {name}: relative L2 {r}")
    lap("frontend vs functional")

    losses, step_ms = frontend_adam(fe, dev, "frontend", smi_line)
    lap("frontend Adam")

    # The front end's utilities on the aov scene.
    aov = make_envtex_scene(device=dev, generic=16)
    fe_aov = frontend_slice_scene(textures=envtex_arrays(generic=16))
    point = torch.tensor(POINT_LIGHT, device=dev)
    with torch.no_grad():
        pairs = {
            "g_buffer": (
                pyredner.render_g_buffer(fe_aov, AOV_CHANNELS, seed=SEED),
                rtt.render_g_buffer(aov, AOV_CHANNELS, seed=SEED)),
            "deferred": (
                pyredner.render_deferred(fe_aov, deferred_lights(point),
                                         alpha=True, aa_samples=2,
                                         seed=SEED),
                rtt.render_deferred(aov, deferred_lights(point), alpha=True,
                                    aa_samples=2, seed=SEED)),
        }
    for name, (a, b) in pairs.items():
        share = pixel_share(a, b, 1e-6)
        print(f"[frontend] aov {name} {tuple(a.shape)}: {share:.6f} of pixels "
              f"at rtol 1e-6 against the functional render", flush=True)
        _check(share >= FRONT_PIXEL_MIN, f"front-end {name}: {share}")
    del aov, fe_aov, pairs
    lap("frontend utilities")

    # remat=True through pyredner.render reaches RenderOptions.
    remat_fe, remat_fe_l = counted(lambda: frontend_gradient(fe, remat=True))
    _check_launches("front-end remat gradient", remat_fe_l, (48, 24))
    for name, a, b in zip(GRAD_LEAVES, remat_fe[1], fgrads):
        r = rel_l2(a, b)
        print(f"[frontend] front-end remat d/d {name}: relative L2 {r:.3e} "
              f"against the front end's live gradient", flush=True)
        _check(bool(torch.isfinite(a).all()) and r <= FRONT_L2_MAX,
               f"front-end remat gradient {name}: relative L2 {r}")

    # isect_replay_max_mb is accepted and changes nothing.
    replay_o = rtt.RenderOptions(num_samples=4, max_bounces=1,
                                 isect_replay_max_mb=256.0)
    with torch.no_grad():
        _, replay_fwd = counted(lambda: rtt.render(scene, replay_o,
                                                   seed=SEED))
    _check_launches("isect_replay_max_mb=256 forward", replay_fwd, (8, 4))
    replay_g, replay_l = counted(lambda: gradient(scene, replay_o))
    _check_launches("isect_replay_max_mb=256 gradient", replay_l, (32, 16))
    for name, a, b in zip(GRAD_LEAVES, replay_g, grads):
        r = rel_l2(a, b)
        print(f"[frontend] isect_replay_max_mb=256 d/d {name}: relative L2 "
              f"{r:.3e} against the live gradient", flush=True)
        _check(r <= FRONT_L2_MAX,
               f"isect_replay_max_mb=256 gradient {name}: relative L2 {r}")
    rows["replay"] = {"launches": replay_fwd,
                      "launches_per_gradient": replay_l}
    lap("frontend remat and the replay option")

    # Remat on the functional slice gradient.
    modes = {
        "live": opts,
        "remat": rtt.RenderOptions(num_samples=4, max_bounces=1, remat=True),
    }
    predicted = {"live": (32, 16), "remat": (48, 24)}
    for mode, o in modes.items():
        gradient(scene, o)  # warm-up
        with torch.no_grad():
            _, fwd_m = counted(lambda: rtt.render(scene, o, seed=SEED))
        _check_launches(f"{mode} forward", fwd_m, (8, 4))
        g, launches = counted(lambda: gradient(scene, o))
        _check_launches(f"{mode} gradient", launches, predicted[mode])
        torch.cuda.reset_peak_memory_stats()
        gradient(scene, o)
        torch.cuda.synchronize()
        rows[mode] = {"launches": fwd_m, "launches_per_gradient": launches,
                      "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
        for name, a, b in zip(GRAD_LEAVES, g, grads):
            r = rel_l2(a, b)
            print(f"[frontend] {mode} d/d {name}: relative L2 {r:.3e} "
                  f"against the live gradient", flush=True)
            _check(bool(torch.isfinite(a).all()) and r <= FRONT_L2_MAX,
                   f"{mode} gradient {name}: relative L2 {r}")
    walls = {mode: [] for mode in modes}
    for _ in range(3):  # interleaved: live, remat, live, ...
        for mode, o in modes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gradient(scene, o)
            torch.cuda.synchronize()
            walls[mode].append((time.perf_counter() - t0) * 1e3)
    for mode in modes:
        rows[mode]["gradient_ms"] = statistics.median(walls[mode])
        print(f"[frontend] {mode} fwd+bwd 256x256 4spp 1 bounce: median "
              f"{rows[mode]['gradient_ms']:.3f} ms of 3 (all: "
              f"{', '.join(f'{w:.2f}' for w in walls[mode])}); peak memory "
              f"{rows[mode]['peak_mib']:.1f} MiB; {smi_line}", flush=True)
    for mode, o in modes.items():  # CUDA kernels and device busy: steadier
        profile_run(f"one {mode} gradient evaluation ({smi_line})",
                    lambda: gradient(scene, o), top=4)
    lap("remat")

    torch.cuda.reset_peak_memory_stats()
    fe_ms, fe_walls = _wall_ms(lambda: frontend_gradient(fe))
    rows["frontend"] = {
        "launches": fwd, "launches_per_gradient": grad_l,
        "gradient_ms": fe_ms,
        "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
        "adam_step_ms": step_ms, "adam_losses": losses}
    print(f"[frontend] front-end fwd+bwd: median {fe_ms:.3f} ms of 3 (all: "
          f"{', '.join(f'{w:.2f}' for w in fe_walls)}); peak memory "
          f"{rows['frontend']['peak_mib']:.1f} MiB; {smi_line}", flush=True)
    return rows


# ----------------------------------------------------------------------
# The lane split over ranks: two on the one card ([sharded]), one a card
# (--cards N)
# ----------------------------------------------------------------------

SHARD_WORLD = 2
SHARD_LAUNCHES = (28, 14)  # per rank of two, by the code (closest, any)
SHARD_IMAGE_ATOL = 1e-6  # sharded vs one process: tests/test_sharding.py
SHARD_L2_MAX = 1e-4  # sharded vs one process, per leaf
SLICE_CELL = ((256, 256), 4)  # (resolution, spp) of [sharded]
CARDS_CELLS = (SLICE_CELL, ((1024, 1024), 4))
TRAIN_STEPS = 5
TRAIN_LR = 3.0
TRAIN_START = [0.8, 0.3, 0.2]  # the sphere's diffuse at step 0
TRAIN_RTOL = 1e-3  # two ranks' losses vs one process's
MIXED_CALLS = 4  # mixed_routes' gradients


def _sphere_diffuse(path):
    """make_train_step's trainable: the sphere's diffuse reflectance."""
    return path.startswith("materials/0/diffuse_reflectance")


def train_losses(opts, mesh, use_edge_sampling=True, profile_step=False):
    """TRAIN_STEPS steps of make_train_step (SGD at TRAIN_LR, seed SEED
    every step; edge-sampled, or continuous with use_edge_sampling=False)
    on the sphere's diffuse, from TRAIN_START toward the slice's render ->
    (losses, ms per step, the profile of one more step or None)."""
    dev = mesh.device
    with torch.no_grad():
        target = rtt.render_image(make_slice_scene(device=dev), opts,
                                  seed=SEED)
    s = make_slice_scene(device=dev, sphere_material=(
        rtt.make_material(diffuse_reflectance=TRAIN_START,
                          specular_reflectance=[0.2, 0.2, 0.2],
                          roughness=[0.05], device=dev)))
    step = make_train_step(opts, mesh=mesh, learning_rate=TRAIN_LR,
                           trainable=_sphere_diffuse,
                           use_edge_sampling=use_edge_sampling)
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, loss = step(s, target, SEED)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    prof = None
    if profile_step:
        prof = profile_run("one train step", lambda: step(s, target, SEED),
                           top=4)
    return losses, step_ms, prof


def gradient_run(scene, opts, mesh=None):
    """The slice's image and one counted gradient, then fwd+bwd (median of
    3; under a mesh every rank starts each run together) and the peak
    memory of those runs; through the sharded entry points over `mesh`
    when one is given.  Where the call replays graphs (a card, outside
    graphs.disable(), no group or an NCCL one), the cache is emptied first,
    the first gradient runs eagerly, the second captures, and the launches
    are the kernel nodes that the gradient's captures record; else the
    launches of one eager gradient.  Returns CPU tensors
    and numbers."""
    graphed = graphs.replays(scene.camera.device, mesh)
    if graphed:
        graphs.clear()
    with torch.no_grad():
        img = (rtt.render_image(scene, opts, seed=SEED) if mesh is None else
               render_image_sharded(scene, opts, seed=SEED, mesh=mesh))
    before = dict(graphs.CAPTURES)
    gradient(scene, opts, mesh=mesh)  # warm-up (graphed: eager, measured)
    if graphed:
        gradient(scene, opts, mesh=mesh)  # the captures
        _check({k: graphs.CAPTURES[k] - before[k] for k in before}
               == {"forward": 1, "backward": 1},
               "the graphed gradient did not capture once")
        grads = gradient(scene, opts, mesh=mesh)
        launches = {k: sum(graphs.LAST_CAPTURE[g]["launches"][k]
                           for g in ("forward", "backward"))
                    for k in ic.LAUNCHES}
    else:
        grads, launches = counted(lambda: gradient(scene, opts, mesh=mesh))
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        if mesh is not None:
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gradient(scene, opts, mesh=mesh)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"image": img.cpu(), "grads": [g.cpu() for g in grads],
            "launches": launches, "walls": walls, "graphed": graphed,
            "captures": {k: graphs.CAPTURES[k] - before[k] for k in before},
            "ms": statistics.median(walls),
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20}


def mixed_routes(mesh, cell=SLICE_CELL):
    """MIXED_CALLS gradients of the slice at `cell` (resolution, spp) over
    `mesh`, this rank's graph cache emptied before call rank + 1: at one
    call the ranks take different routes (a key's first call runs
    eagerly, its second captures, later ones replay), which must issue
    the same collectives.  Returns per call its gradients and this
    rank's captures."""
    res, spp = cell
    scene = make_slice_scene(res=res, device=mesh.device)
    opts = rtt.RenderOptions(num_samples=spp, max_bounces=1)
    graphs.clear()
    rows = []
    for call in range(MIXED_CALLS):
        if call == mesh.rank + 1:
            graphs.clear()
        before = dict(graphs.CAPTURES)
        grads = gradient(scene, opts, mesh=mesh)
        rows.append({"grads": [g.cpu() for g in grads], "captures": {
            k: graphs.CAPTURES[k] - before[k] for k in before}})
    graphs.clear()
    return rows


SHARDED_SECOND_ORDER = ("render_sharded", "render_image_sharded")


def sharded_second_order(scene, opts, mesh):
    """second_order through render_sharded and render_image_sharded over
    `mesh` (every rank starting each together) -> name -> {"h": the
    leaves' second derivatives (CPU) and "launches": the kernels'
    launches from Python in the first call (its eager forward and its two
    eager backwards), "ms": the wall of a later call (on a graphed route,
    after the call that captures the forward)}."""
    fns = {"render_sharded": lambda s: render_sharded(s, opts, seed=SEED,
                                                      mesh=mesh),
           "render_image_sharded": lambda s: render_image_sharded(
               s, opts, seed=SEED, mesh=mesh)}
    out = {}
    for name in SHARDED_SECOND_ORDER:
        dist.barrier()
        h, launches = counted(lambda: second_order(fns[name], scene))
        out[name] = {"h": [x.cpu() for x in h], "launches": launches}
    for name in SHARDED_SECOND_ORDER:  # walls, after the first calls
        if graphs.replays(scene.camera.device, mesh):
            second_order(fns[name], scene)  # the forward's capture
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        second_order(fns[name], scene)
        torch.cuda.synchronize()
        out[name]["ms"] = (time.perf_counter() - t0) * 1e3
    return out


def mixed_second_order(mesh, cell=SLICE_CELL):
    """MIXED_CALLS calls of sharded_second_order at `cell` over `mesh`,
    this rank's graph cache emptied before call rank + 1, as in
    mixed_routes: at one call the ranks' forwards take different routes
    (eager, capture, replay) and their eager backwards must still issue
    the same collectives.  Returns per call its second derivatives and
    this rank's captures."""
    res, spp = cell
    scene = make_slice_scene(res=res, device=mesh.device)
    opts = rtt.RenderOptions(num_samples=spp, max_bounces=1)
    fns = {"render_sharded": render_sharded,
           "render_image_sharded": render_image_sharded}
    graphs.clear()
    rows = []
    for call in range(MIXED_CALLS):
        if call == mesh.rank + 1:
            graphs.clear()
        before = dict(graphs.CAPTURES)
        h = {name: [x.cpu() for x in second_order(
                lambda s: fns[name](s, opts, seed=SEED, mesh=mesh), scene)]
             for name in SHARDED_SECOND_ORDER}
        rows.append({"h": h, "captures": {
            k: graphs.CAPTURES[k] - before[k] for k in before}})
    graphs.clear()
    return rows


def _rank(devices, cells, train, mixed=False, second=False):
    """One spawned rank (parallel.spawn.run_ranks) on
    devices[rank]: gradient_run over the mesh for each (resolution, spp)
    cell, on the route the group's backend picks (gloo: eager; NCCL:
    graphed); with train, also a profile of one gradient and the train
    step's losses (on the first cell); with second, the first cell's
    sharded_second_order; with mixed, mixed_routes and
    mixed_second_order last."""
    dev = torch.device(devices[dist.get_rank()])
    torch.cuda.set_device(dev)
    mesh = make_mesh(dev)
    out = []
    for res, spp in cells:
        scene = make_slice_scene(res=res, device=dev)
        opts = rtt.RenderOptions(num_samples=spp, max_bounces=1)
        out.append(gradient_run(scene, opts, mesh))
        if train:
            dist.barrier()
            profile_run(f"rank {mesh.rank} of {mesh.world}: one gradient "
                        "evaluation",
                        lambda: gradient(scene, opts, mesh=mesh), top=4)
            out[-1]["losses"], out[-1]["step_ms"], _ = train_losses(opts,
                                                                    mesh)
        if second and len(out) == 1:
            out[-1]["second_order"] = sharded_second_order(scene, opts, mesh)
        del scene
        graphs.clear()
    if mixed:
        out.append(mixed_routes(mesh))
        out.append(mixed_second_order(mesh))
    return out


def spawn_ranks(world, devices, cells, train, backend, mixed=False,
                second=False):
    """_rank on `world` spawned ranks -> per rank, its list of cells (and
    with mixed, mixed_routes's and mixed_second_order's rows last)."""
    with tempfile.TemporaryDirectory() as tmp:
        return run_ranks(world, _rank, (devices, cells, train, mixed, second),
                         tmp, backend=backend)


def _compare_sharded(tag, label, out, ref):
    diff = float((out["image"] - ref["image"]).abs().max())
    print(f"[{tag}] {label}: image max |diff| {diff:.3e} against one "
          f"process (gate atol {SHARD_IMAGE_ATOL})", flush=True)
    _check(diff <= SHARD_IMAGE_ATOL, f"{label}: image differs by {diff}")
    for name, a, b in zip(GRAD_LEAVES, out["grads"], ref["grads"]):
        r = rel_l2(a, b)
        print(f"[{tag}] {label}: d/d {name} relative L2 {r:.3e} against "
              f"one process (gate {SHARD_L2_MAX})", flush=True)
        _check(bool(torch.isfinite(a).all()) and r <= SHARD_L2_MAX,
               f"{label}: gradient {name}: relative L2 {r}")
    _check(all(v > 0 for v in out["launches"].values()),
           f"{label}: a kernel did not launch: {out['launches']}")


def _compare_ranks(tag, label, ranks, ref):
    """Each rank against one process; the ranks' gradients equal."""
    for r, out in enumerate(ranks):
        _compare_sharded(tag, f"{label}, rank {r} of {len(ranks)}", out, ref)
        for a, b in zip(out["grads"], ranks[0]["grads"]):
            _check(torch.equal(a, b), f"{label}: the ranks' gradients differ")


def _walls(ws):
    return ", ".join(f"{w:.2f}" for w in ws)


def nccl_train(opts, mesh, refs, smi_line):
    """TRAIN_STEPS steps of make_train_step over the one-rank NCCL `mesh`,
    which replay graphs, edge-sampled and continuous, against one
    process's eager steps (refs: label -> losses): the loss falls at every
    step and matches within TRAIN_RTOL.  The step's wall (the first step
    runs eagerly, the second captures) and the CUDA kernels and idle
    share of one more step.
    Returns label -> row."""
    rows = {}
    for label, edges in (("edge-sampled", True), ("continuous", False)):
        before = dict(graphs.CAPTURES)
        losses, ms, prof = train_losses(opts, mesh, edges, profile_step=True)
        captures = {k: graphs.CAPTURES[k] - before[k] for k in before}
        print(f"[sharded] one-rank NCCL group, graphed {label} train step: "
              f"losses {losses}, one process (eager) {refs[label]}; "
              f"captures {captures}; step ms {_walls(ms)} (the first eager, "
              f"the second captures), median of the later "
              f"{statistics.median(ms[2:]):.3f}"
              f"; {smi_line}", flush=True)
        _check(all(b < a for a, b in zip(losses, losses[1:])),
               f"graphed {label} train: the loss did not fall: {losses}")
        _check(np.allclose(losses, refs[label], rtol=TRAIN_RTOL, atol=0.0),
               f"graphed {label} train: losses differ from one process's")
        _check(captures["backward"] == 1,
               f"graphed {label} train: captures {captures}")
        rows[label] = {"losses": losses, "step_ms": ms,
                       "captures": captures}
        if prof is not None:
            rows[label].update(cuda_kernels=prof["kernels"],
                               busy_ms=prof["busy_ms"], idle=prof["idle"])
    return rows


def phase_sharded(scene, opts, smi_line):
    """The slice over two ranks on the one card (gloo: NCCL refuses two
    ranks on one device) and over a one-rank NCCL group, against one
    process: image, gradients, the train step, launches per rank, peak
    memory per rank and fwd+bwd.  One process, the NCCL group's eager
    route and the gloo pair run eagerly (the pair by its backend: gloo
    collectives are host calls, so its calls capture nothing); then the
    NCCL group's render_sharded replays graphs with its collectives
    captured (graph_route) and is held against one process too, and
    make_train_step's graphed steps, edge-sampled and continuous, against
    one process's.  Returns the row for the kernels line."""
    dev = scene.camera.device
    lap = _Lap(time.perf_counter())
    with graphs.disable():
        ref = gradient_run(scene, opts)
        profile_run("one process: one gradient evaluation",
                    lambda: gradient(scene, opts), top=4)
        ref_losses, ref_step_ms, _ = train_losses(opts, make_mesh(dev))
        ref_cont, _, _ = train_losses(opts, make_mesh(dev), False)
    lap("sharded: one process")

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
            world_size=1, timeout=COLLECTIVE_TIMEOUT)
        try:
            mesh = make_mesh(dev)
            with graphs.disable():
                nccl = gradient_run(scene, opts, mesh)
            lap("sharded: one-rank NCCL group, eager")
            graphs.clear()
            nccl_second = sharded_second_order(scene, opts, mesh)
            graphs.clear()
            lap("sharded: one-rank NCCL group, second derivatives")
            graphs.clear()
            graphed = graph_route(
                "render_sharded (one-rank NCCL group)",
                (scene, GRAD_LEAVES, slice_leaves,
                 lambda s, sd: render_sharded(s, opts, seed=sd, mesh=mesh)),
                smi_line, tag="sharded")
            with torch.no_grad():
                img = render_image_sharded(scene, opts, seed=SEED, mesh=mesh)
            _compare_sharded("sharded", "one-rank NCCL group, graphed", {
                "image": img.cpu(), "launches": graphed["nodes_total"],
                "grads": [g.cpu() for g in gradient(scene, opts, mesh=mesh)]},
                ref)
            lap("sharded: one-rank NCCL group, graphed")
            train = nccl_train(opts, mesh, {"edge-sampled": ref_losses,
                                            "continuous": ref_cont}, smi_line)
            lap("sharded: one-rank NCCL group, graphed train steps")
        finally:
            dist.destroy_process_group()
            graphs.clear()
    print(f"[sharded] one-rank NCCL group (eager): launches "
          f"{nccl['launches']}", flush=True)
    _check((nccl["launches"]["closest_hit"], nccl["launches"]["any_hit"])
           == (32, 16), f"one-rank NCCL launches {nccl['launches']}, want "
           "32 + 16")
    _compare_sharded("sharded", "one-rank NCCL group", nccl, ref)

    ranks = [cells[0] for cells in spawn_ranks(
        SHARD_WORLD, [str(dev)] * SHARD_WORLD, [SLICE_CELL], True, "gloo",
        second=True)]
    lap(f"sharded: {SHARD_WORLD} gloo ranks (spawned)")
    _compare_ranks("sharded", "one card", ranks, ref)
    for r, out in enumerate(ranks):
        got = (out["launches"]["closest_hit"], out["launches"]["any_hit"])
        print(f"[sharded] rank {r} of {SHARD_WORLD} (gloo, one card): eager "
              f"by the group's backend (graphed {out['graphed']}, captures "
              f"{out['captures']}); launches per gradient {out['launches']}, "
              f"predicted {SHARD_LAUNCHES}; peak memory {out['peak_mib']} MiB "
              f"(one process: {ref['peak_mib']} MiB)", flush=True)
        _check(not out["graphed"] and not any(out["captures"].values()),
               f"rank {r}: a gloo rank captured {out['captures']}")
        _check(got == SHARD_LAUNCHES, f"rank {r} launches {got}, want "
               f"{SHARD_LAUNCHES}")
        losses = out["losses"]
        print(f"[sharded] rank {r} train step losses {losses}; one process "
              f"{ref_losses}", flush=True)
        _check(all(b < a for a, b in zip(losses, losses[1:])),
               f"rank {r}: the loss did not fall at every step: {losses}")
        _check(np.allclose(losses, ref_losses, rtol=TRAIN_RTOL, atol=0.0),
               f"rank {r}: train losses differ from one process's")
    slowest = [max(w) for w in zip(*(out["walls"] for out in ranks))]
    two_ms = statistics.median(slowest)
    print(f"[sharded] fwd+bwd 256x256 4spp 1 bounce: one process median "
          f"{ref['ms']:.3f} ms (all: {_walls(ref['walls'])}); {SHARD_WORLD} "
          f"ranks on one card (slowest rank) median {two_ms:.3f} ms (all: "
          f"{_walls(slowest)}); one-rank NCCL group eager median "
          f"{nccl['ms']:.3f} ms, graphed median {graphed['graphed_ms']:.3f} "
          f"ms; train step ms one process "
          f"{[round(x, 1) for x in ref_step_ms]}, rank 0 "
          f"{[round(x, 1) for x in ranks[0]['step_ms']]}; {smi_line}",
          flush=True)
    return {"launches_per_rank": [out["launches"] for out in ranks],
            "launches_one_rank_nccl": nccl["launches"],
            "peak_mib_per_rank": [out["peak_mib"] for out in ranks],
            "peak_mib_one_process": ref["peak_mib"],
            "gradient_ms_one_process": ref["ms"],
            "gradient_ms_two_ranks": two_ms,
            "train_losses": ranks[0]["losses"],
            "nccl_graphed": {k: graphed.get(k) for k in (
                "eager_ms", "graphed_ms", "capture_s", "max_image_diff",
                "max_rel_l2", "busy_ms", "idle", "nodes_total")},
            "nccl_train": train,
            "second_order": {
                **{f"gloo rank {r} of {SHARD_WORLD}": out["second_order"]
                   for r, out in enumerate(ranks)},
                "one-rank NCCL group": nccl_second}}


# ----------------------------------------------------------------------
# The compiled render: render and render_image as cached CUDA graphs
# ----------------------------------------------------------------------

GRAPH_IMAGE_ATOL = 1e-6  # graphed vs eager image, every pixel
GRAPH_L2_MAX = 1e-4  # graphed vs eager gradient, relative L2 per leaf
GRAPH_LOSS_RTOL = 1e-3  # the front end's Adam losses, graphed vs eager
GRAPH_NODES = {"closest_hit": 32, "any_hit": 16}  # per graphed gradient
GRAPH_BIG = ((1024, 1024), 4)  # the device-bound contrast


def img_grads(fn, leaves):
    """fn()'s image and the gradients of sum(image * w) w.r.t. leaves, w
    weighting the channels 0.5..1.5; with no leaves, fn() under no_grad
    and no gradients (a forward-only route)."""
    if not leaves:
        with torch.no_grad():
            return fn(), []
    for x in leaves:
        x.requires_grad_(True)
    try:
        img = fn()
        w = torch.linspace(0.5, 1.5, img.shape[-1], device=img.device)
        grads = torch.autograd.grad(torch.sum(img * w), leaves)
        return img.detach(), [g.detach() for g in grads]
    finally:
        for x in leaves:
            x.requires_grad_(False)


def graph_paths(scene, opts, env, aov):
    """name -> (scene, leaf names, leaves of a scene, render(scene, seed)):
    the slice, envtex and G-buffer gradients and one remat gradient
    (render's graphs); the slice's continuous gradient through
    render_image (its autograd graphs) and the aov scene's screen
    gradient (forward only, no leaves)."""
    remat = rtt.RenderOptions(num_samples=4, max_bounces=1, remat=True)
    screen = rtt.RenderOptions(**SCREEN_OPTS)
    return {
        "slice": (scene, GRAD_LEAVES, slice_leaves,
                  lambda s, sd: rtt.render(s, opts, seed=sd)),
        "envtex": (env, ENVTEX_LEAVES, envtex_leaves,
                   lambda s, sd: rtt.render(s, opts, seed=sd)),
        "g_buffer": (aov, AOV_LEAVES["g_buffer"], gbuffer_leaves,
                     lambda s, sd: rtt.render_g_buffer(s, AOV_CHANNELS,
                                                       seed=sd)),
        "remat": (scene, GRAD_LEAVES, slice_leaves,
                  lambda s, sd: rtt.render(s, remat, seed=sd)),
        "render_image_grad": (scene, GRAD_LEAVES, slice_leaves,
                              lambda s, sd: rtt.render_image(s, opts,
                                                             seed=sd)),
        "screen_gradient": (aov, (), lambda s: [],
                            lambda s, sd: rtt.screen_gradient_image(
                                s, screen, seed=sd)),
    }


def sync_check(paths, names, warm=True):
    """The eager routes of paths[name] for each name under
    torch.cuda.set_sync_debug_mode("error"): a host sync raises (after one
    warm run, which makes the kept constants and, under a group, the
    communicator; warm=False when the caller ran one)."""
    with graphs.disable():
        for name in names:
            scene, _, leaves_of, fn = paths[name]
            if warm:
                img_grads(lambda: fn(scene, SEED), leaves_of(scene))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                img_grads(lambda: fn(scene, SEED), leaves_of(scene))
            except RuntimeError as e:
                print(f"FAIL: [graph] the eager {name} route synchronises "
                      f"the host: {e}", flush=True)
                raise
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            print(f"[graph] sync check: the eager {name} route ran under "
                  "sync debug mode \"error\" with no synchronising call",
                  flush=True)


def graph_vs_eager(name, path, smi_line, tag="graph"):
    """One path graphed against eager at seeds 11 and 12 and after an
    in-place update of the sphere's vertices (x 1.01): the image within
    GRAPH_IMAGE_ATOL on every pixel, each leaf's gradient within
    GRAPH_L2_MAX relative L2, the eager-vs-eager value beside it (the
    index backward's atomics); a forward-only path (no leaves; the screen
    gradient, whose primary-edge scatter sums with atomics) holds its
    image to GRAPH_L2_MAX relative L2, its max |diff| printed beside
    eager vs eager.  The first call runs eagerly (the cache measures it),
    the second captures one forward graph (and one backward for a
    gradient) and a later call captures nothing.  Then the
    wall, graphed and eager (median of 3 each), while the key is cached.
    Returns the row."""
    scene, names, leaves_of, fn = path
    grad = bool(names)
    row = {"captures": [], "capture_s": None, "max_image_diff": 0.0,
           "max_rel_l2": 0.0}
    vertices = scene.shapes[0].vertices
    keep = vertices.detach().clone()
    steps = (("seed 11", SEED), ("seed 12", SEED + 1),
             ("leaf update", SEED + 1))
    if name == "remat":
        steps = steps[:2]
    ee = None
    for step, seed in steps:
        if step == "leaf update":
            with torch.no_grad():
                vertices.mul_(1.01)
        before = dict(graphs.CAPTURES)
        g_img, g_grads = img_grads(lambda: fn(scene, seed), leaves_of(scene))
        torch.cuda.synchronize()
        got = {k: graphs.CAPTURES[k] - before[k] for k in before}
        row["captures"].append(got)
        if row["capture_s"] is None and any(got.values()):
            kinds = [k for k in ("forward", "backward") if got[k]]
            row["capture_s"] = {k: graphs.LAST_CAPTURE[k]["seconds"]
                                for k in kinds}
            row["nodes"] = {k: graphs.LAST_CAPTURE[k]["launches"]
                            for k in kinds}
        with graphs.disable():
            e_img, e_grads = img_grads(lambda: fn(scene, seed),
                                       leaves_of(scene))
            if ee is None:
                e2_img, e2 = img_grads(lambda: fn(scene, seed),
                                       leaves_of(scene))
                ee = [rel_l2(a, b) for a, b in zip(e2, e_grads)]
                ee_img = float((e2_img - e_img).abs().max())
        diff = float((g_img - e_img).abs().max())
        row["max_image_diff"] = max(row["max_image_diff"], diff)
        if grad:
            l2 = [rel_l2(a, b) for a, b in zip(g_grads, e_grads)]
            print(f"[{tag}] {name} {step}: captures {got}; image max "
                  f"|graphed - eager| {diff:.3e}; gradient relative L2 "
                  "graphed vs eager " + ", ".join(
                      f"{n} {x:.3e} (eager vs eager {y:.3e})"
                      for n, x, y in zip(names, l2, ee)), flush=True)
            _check(diff <= GRAPH_IMAGE_ATOL,
                   f"{name} {step}: graphed image off eager by {diff:.3e}")
            _check(all(bool(torch.isfinite(g).all()) for g in g_grads),
                   f"{name} {step}: non-finite graphed gradient")
        else:
            l2 = [rel_l2(g_img, e_img)]
            print(f"[{tag}] {name} {step}: captures {got}; image relative "
                  f"L2 graphed vs eager {l2[0]:.3e}, max |graphed - eager| "
                  f"{diff:.3e} (eager vs eager {ee_img:.3e})", flush=True)
            _check(bool(torch.isfinite(g_img).all()),
                   f"{name} {step}: non-finite graphed image")
        row["max_rel_l2"] = max(row["max_rel_l2"], max(l2))
        _check(max(l2) <= GRAPH_L2_MAX,
               f"{name} {step}: graphed result off eager ({max(l2):.3e})")
    with torch.no_grad():
        vertices.copy_(keep)
    want = {"forward": 1, "backward": int(grad)}
    none = {"forward": 0, "backward": 0}
    _check(row["captures"][:2] == [none, want],
           f"{name}: the first two calls captured {row['captures'][:2]}, "
           f"want {none} (eager) then {want}")
    _check(all(c == none for c in row["captures"][2:]),
           f"{name}: a later call captured again: {row['captures']}")
    print(f"[{tag}] {name}: capture seconds "
          f"{row['capture_s']}; kernel nodes {row['nodes']}", flush=True)
    run = lambda: img_grads(lambda: fn(scene, SEED), leaves_of(scene))
    row["graphed_ms"], g_walls = _wall_ms(run)
    with graphs.disable():
        row["eager_ms"], e_walls = _wall_ms(run)
    what = "fwd+bwd" if grad else "forward"
    print(f"[{tag}] {name} {what}: eager median {row['eager_ms']:.3f} ms "
          f"(all: {_walls(e_walls)}), graphed median {row['graphed_ms']:.3f} "
          f"ms (all: {_walls(g_walls)}); {smi_line}", flush=True)
    return row


SCREEN_ROUNDS = 2  # rounds of screen_gradient_loop (--screen-rounds N)
# Where a failed round's tensors go (results/ is not committed).
OUT_DIR = os.environ.get("CHIP_SMOKE_OUT",
                         os.path.join(ROOT, "results", "chip_smoke"))
EDGE_SAMPLE_KEYS = ("f_plus", "f_minus", "px", "py", "pdf", "x_pix",
                    "n_hat", "inside")


def _release_graphs():
    """Every cached program's graphs released, their measurements kept:
    each key's next call captures again."""
    for prog in graphs._cache.values():
        prog.graphs = dict.fromkeys(graphs.KINDS)
    gc.collect()


def _recording_edge_samples(store):
    """A stand-in for edge._sample_primary_edges that keeps a copy of each
    call's samples in `store`."""
    real = edge_mod._sample_primary_edges

    def rec(*args, **kw):
        out = real(*args, **kw)
        store.append({k: out[k].detach().clone() for k in EDGE_SAMPLE_KEYS})
        return out
    return real, rec


def _sample_differences(a, b, top=5):
    """The primary-edge samples of two runs compared: per key, the lanes
    that differ and the first few of them."""
    out = {}
    for k in EDGE_SAMPLE_KEYS:
        x, y = a[k], b[k]
        if x.shape != y.shape:
            out[k] = f"shapes {tuple(x.shape)} and {tuple(y.shape)}"
            continue
        bad = (x != y).reshape(x.shape[0], -1).any(dim=1)
        lanes = torch.nonzero(bad).reshape(-1)[:top].tolist()
        out[k] = {"lanes": int(bad.sum()), "first": [
            (i, x[i].tolist(), y[i].tolist()) for i in lanes]}
    return out


def screen_gradient_loop(path, rounds, smi_line):
    """The screen gradient's route, in the script's order, `rounds` times:
    its graph released and captured again (the key keeps its measured
    need, so its next call captures) and replayed, then two eager runs
    (graphs.disable()) whose primary-edge samples are recorded.  Gate:
    every pair of the three images within GRAPH_L2_MAX relative L2 (the
    route's gate; eager runs differ by the edge scatter's atomics).  A
    round that fails saves its images and both eager runs' samples to
    OUT_DIR/screen_gradient_round<i>.pt and prints the samples that
    differ, then the script fails.  Returns the row."""
    scene, _, _, fn = path
    worst, failed = 0.0, []
    for i in range(rounds):
        _release_graphs()
        before = dict(graphs.CAPTURES)
        with torch.no_grad():
            g = fn(scene, SEED)
            if graphs.CAPTURES["forward"] == before["forward"]:
                g = fn(scene, SEED)  # the key was evicted: this captures
        samples = []
        real, rec = _recording_edge_samples(samples)
        edge_mod._sample_primary_edges = rec
        try:
            with graphs.disable(), torch.no_grad():
                e1 = fn(scene, SEED)
                e2 = fn(scene, SEED)
        finally:
            edge_mod._sample_primary_edges = real
        torch.cuda.synchronize()
        _check(graphs.CAPTURES["forward"] - before["forward"] == 1,
               f"screen gradient loop, round {i + 1}: no capture")
        l2 = {"graphed vs eager 1": rel_l2(g, e1),
              "graphed vs eager 2": rel_l2(g, e2),
              "eager 1 vs eager 2": rel_l2(e1, e2)}
        diff = {k: float((a - b).abs().max()) for k, (a, b) in zip(
            l2, ((g, e1), (g, e2), (e1, e2)))}
        worst = max(worst, max(l2.values()))
        print(f"[graph] screen gradient loop, round {i + 1} of {rounds}: "
              f"captures {graphs.CAPTURES['forward'] - before['forward']}; "
              f"relative L2 {l2}; max |diff| {diff}", flush=True)
        if max(l2.values()) > GRAPH_L2_MAX or not all(
                bool(torch.isfinite(x).all()) for x in (g, e1, e2)):
            failed.append(i + 1)
            where = os.path.join(OUT_DIR, f"screen_gradient_round{i + 1}.pt")
            os.makedirs(os.path.dirname(where), exist_ok=True)
            torch.save({"graphed": g.cpu(), "eager": [e1.cpu(), e2.cpu()],
                        "samples": [{k: v.cpu() for k, v in x.items()}
                                    for x in samples]}, where)
            pix = torch.nonzero((e1 - e2).abs().amax(dim=(2, 3))
                                > 1e-3).tolist()
            print(f"[graph] screen gradient loop, round {i + 1}: pixels "
                  f"where the eager runs differ by > 1e-3: {pix[:10]}; "
                  f"their primary-edge samples: "
                  f"{_sample_differences(samples[0], samples[1])}; saved "
                  f"to {where}", flush=True)
    # One more eager run with every uninitialised allocation NaN-filled
    # (torch.empty and its kin; deterministic algorithms, warnings only):
    # a read of memory the path never wrote shows as a NaN or a change.
    # An op with a deterministic variant that rounds differently would
    # show too, where its rounding changes a discrete decision.
    import torch.utils.deterministic as det
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = True
    filled_samples = []
    real, rec = _recording_edge_samples(filled_samples)
    edge_mod._sample_primary_edges = rec
    try:
        with graphs.disable(), torch.no_grad():
            filled = fn(scene, SEED)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        det.fill_uninitialized_memory = saved[2]
        edge_mod._sample_primary_edges = real
    fill_l2 = rel_l2(filled, e2)
    print(f"[graph] screen gradient, an eager run under deterministic "
          f"algorithms with uninitialised memory NaN-filled: finite "
          f"{bool(torch.isfinite(filled).all())}, relative L2 against the "
          f"last eager run {fill_l2:.3e} (gate {GRAPH_L2_MAX})", flush=True)
    if fill_l2 > GRAPH_L2_MAX:
        print(f"[graph] its primary-edge samples against the last eager "
              f"run's: {_sample_differences(filled_samples[0], samples[1])}",
              flush=True)
    scans = scan_determinism(scene.camera.device)
    print(f"[graph] screen gradient loop: {rounds} rounds, worst relative "
          f"L2 {worst:.3e} (gate {GRAPH_L2_MAX}), failed rounds {failed}; "
          f"{smi_line}", flush=True)
    _check(not failed, f"the screen gradient's loop failed rounds {failed}")
    _check(bool(torch.isfinite(filled).all()) and fill_l2 <= GRAPH_L2_MAX,
           "the screen gradient reads uninitialised memory or depends on "
           "a nondeterministic rounding")
    return {"rounds": rounds, "worst_rel_l2": worst, "filled_rel_l2": fill_l2,
            "scans": scans}


SCAN_RUNS = 100  # scans of one sampling table in scan_determinism
SCAN_LEN = 1 << 17  # entries of that table: many of CUB's scan tiles


def scan_determinism(dev):
    """One one-dimensional float sampling table (SCAN_LEN entries, a third
    zero, made from SEED) scanned SCAN_RUNS times by torch.cumsum and by
    the port's vecmath.cumsum: how many different results each gave.
    Gate: the port's, one.  Returns the counts."""
    rng = np.random.default_rng(SEED)
    w = rng.exponential(1.0, SCAN_LEN) * (rng.uniform(size=SCAN_LEN) > 1 / 3)
    pmf = torch.as_tensor(w / w.sum(), dtype=torch.float32, device=dev)
    counts = {}
    for name, scan in (("torch.cumsum", lambda x: torch.cumsum(x, dim=0)),
                       ("vecmath.cumsum", lambda x: vm.cumsum(x, dim=0))):
        runs = torch.stack([scan(pmf) for _ in range(SCAN_RUNS)])
        counts[name] = int(torch.unique(runs, dim=0).shape[0])
    print(f"[graph] a {SCAN_LEN}-entry float32 sampling table scanned "
          f"{SCAN_RUNS} times: distinct results {counts}", flush=True)
    _check(counts["vecmath.cumsum"] == 1,
           f"the port's scan gave {counts['vecmath.cumsum']} results")
    return counts


def graph_batches(path, tag="graph", cap=None):
    """Both kernels against their plain versions on every batch of one
    eager run of `path` (cap: capture_launches of one, when the caller
    has it), through the device-count interface: no lane may differ.
    Returns (batches, lanes, lanes off)."""
    scene, _, leaves_of, fn = path
    if cap is None:
        with graphs.disable():
            cap = capture_launches(
                lambda: img_grads(lambda: fn(scene, SEED), leaves_of(scene)))
    fs = rtt.flatten_scene(scene)
    lanes = off = 0
    with torch.no_grad():
        for kind, rb in cap:
            if kind == "closest_hit":
                kt, ki = ic.closest_hit(fs.layout, rb)
                pt, pi = plain.closest_plain(fs.layout.Tc, rb)
                bad = int(((ki.to(torch.int64) != pi)
                           | ((kt != pt) & torch.isfinite(pt))).sum())
            else:
                bad = int(((ic.any_hit(fs.layout, rb) != 0)
                           != plain.anyhit_plain(fs.layout.Tc, rb)[0]).sum())
            lanes += rb.n
            off += bad
    print(f"[{tag}] kernels vs plain through the device count: {len(cap)} "
          f"captured batches, {lanes} lanes, {off} lanes off", flush=True)
    _check(off == 0, f"{off} lanes off the plain versions")
    return len(cap), lanes, off


HOST_META = ("torch/_refs", "torch/_prims", "torch/_decomp", "torch/_library",
             "torch/_dynamo", "torch/_meta_registrations",
             "torch/fx/experimental/symbolic_shapes")


def host_profile(label, run, top=8):
    """cProfile of one run on the host: its seconds (under the profiler),
    the part in PyTorch's Python reference and meta functions (HOST_META:
    where forward AD's ZeroTensor tangents compute their result shapes),
    the calls into torch._refs, the entries into the reference wrappers
    from torch.maximum and torch.minimum, and the functions with the most
    own time."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof).stats
    total = sum(v[2] for v in st.values())
    meta = sum(v[2] for k, v in st.items()
               if any(m in k[0] for m in HOST_META))
    refs = sum(v[0] for k, v in st.items() if "torch/_refs" in k[0])
    minmax = sum(c[1] for k, v in st.items()
                 if "_prims_common/wrappers.py" in k[0]
                 for caller, c in v[4].items()
                 if caller[2] in ("<built-in method torch.maximum>",
                                  "<built-in method torch.minimum>"))
    print(f"[host] {label} under cProfile: {total:.3f} s of host time, "
          f"{meta:.3f} s ({meta / total:.3f}) in PyTorch's Python reference "
          f"and meta functions, {refs} calls into torch._refs, {minmax} "
          f"entries from torch.maximum/minimum", flush=True)
    for (path, line, fn), v in sorted(st.items(), key=lambda kv: -kv[1][2])[
            :top]:
        print(f"[host]   {v[2]:8.3f} s own {v[0]:8d}x  "
              f"{os.path.basename(path)}:{line}({fn})", flush=True)
    return {"host_s": total, "meta_s": meta, "refs_calls": refs,
            "minmax_entries": minmax}


def graph_route(name, path, smi_line, tag="graph", host=False):
    """A route graphed since the whole port is compiled (the continuous
    gradient, the screen gradient, a sharded render over NCCL), checked
    as [graph] checks the slice's gradient: its eager route under sync
    debug mode "error"; the route's launch counts zeroed just before its
    first graphed call and read after the graphed-vs-eager checks
    (graph_vs_eager); the kernel nodes counted at capture and in a
    profile of one graphed run, each equal to the eager route's launches
    (render_image's graphed backward walks the forward graph's kept tape,
    as eager autograd walks the forward's); the device's busy and idle
    share of that run; both kernels against their plain versions on every
    batch of the eager route.  One eager run gives the launches and the batches and warms
    the sync check; with `host`, under host_profile.  Returns the row."""
    scene, _, leaves_of, fn = path
    run = lambda: img_grads(lambda: fn(scene, SEED), leaves_of(scene))
    first = []
    with graphs.disable():
        eager_run = lambda: first.append(
            counted(lambda: capture_launches(run)))
        host_row = (host_profile(f"one eager {name} run", eager_run) if host
                    else eager_run())
    cap, eager = first[0]
    sync_check({name: path}, [name], warm=False)
    want = dict(eager)
    torch.cuda.synchronize()
    reset_launches()
    row = graph_vs_eager(name, path, smi_line, tag)
    main = dict(ic.LAUNCHES)
    gathers = note_gather(f"{tag}.{name}")
    nodes = {k: sum(n[k] for n in row["nodes"].values()) for k in eager}
    print(f"[{tag}] {name} launches (capture and the eager comparisons "
          f"included) {main}, row gathers {gathers}; kernel nodes at "
          f"capture {nodes}, the eager route's launches {eager}, predicted "
          f"nodes {want}", flush=True)
    _check(all(v > 0 for v in main.values()),
           f"{name}: a kernel did not launch on the graphed route: {main}")
    _check(nodes == want, f"{name}: kernel nodes {nodes}, want {want}")
    row.update(eager_launches=eager, nodes_total=nodes)
    prof = profile_run(f"one graphed {name} run", run, top=6)
    if prof is not None:
        replay = {k: sum(c for n, c in prof["by_name"].items()
                         if f"{k}_kernel" in n) for k in eager}
        row.update(busy_ms=prof["busy_ms"], idle=prof["idle"],
                   cuda_kernels=prof["kernels"], replay_nodes=replay)
        print(f"[{tag}] {name}: kernel nodes in one graphed run's replays "
              f"(profiler) {replay}", flush=True)
        _check(replay == want,
               f"{name}: profiled kernel nodes {replay}, want {want}")
    row["batches"] = graph_batches(path, tag, cap)
    if host:
        row["host"] = host_row
    return row


def phase_graph(scene, opts, smi_line):
    """render and render_image replayed as cached CUDA graphs against the
    eager functions; see the module doc.  Returns the row for the kernels
    line."""
    lap = _Lap(time.perf_counter())
    dev = scene.camera.device
    graphs.clear()
    torch.cuda.empty_cache()
    env = make_envtex_scene(device=dev)
    aov = make_envtex_scene(generic=16, device=dev)
    paths = graph_paths(scene, opts, env, aov)
    render_keys = ("slice", "envtex", "g_buffer", "remat")
    sync_check(paths, render_keys[:3])
    lap("graph: sync check")

    # The main path through the graphs: the counts zeroed before the first
    # call of the slice's gradient, read after (its capture launches).
    torch.cuda.synchronize()
    reset_launches()
    rows = {"slice": graph_vs_eager("slice", paths["slice"], smi_line)}
    main = dict(ic.LAUNCHES)
    gathers = note_gather("graph.slice")
    nodes = {k: sum(rows["slice"]["nodes"][g][k]
                    for g in ("forward", "backward")) for k in GRAPH_NODES}
    print(f"[graph] slice main path (capture included) launches {main}, "
          f"row gathers {gathers}; "
          f"kernel nodes per graphed gradient {nodes}, predicted "
          f"{GRAPH_NODES}", flush=True)
    _check(all(v > 0 for v in main.values()),
           f"a kernel did not launch on the graphed main path: {main}")
    _check(nodes == GRAPH_NODES, f"kernel nodes {nodes}, want {GRAPH_NODES}")
    s, _, leaves_of, fn = paths["slice"]
    prof = profile_run("one graphed slice gradient", lambda: img_grads(
        lambda: fn(s, SEED), leaves_of(s)), top=6)
    if prof is not None:
        replay_nodes = {k: sum(c for n, c in prof["by_name"].items()
                               if f"{k}_kernel" in n) for k in GRAPH_NODES}
        rows["slice"].update(busy_ms=prof["busy_ms"], idle=prof["idle"],
                             cuda_kernels=prof["kernels"],
                             replay_nodes=replay_nodes)
        print(f"[graph] kernel nodes in one graphed gradient's replays "
              f"(profiler): {replay_nodes}", flush=True)
        _check(replay_nodes == GRAPH_NODES,
               f"profiled kernel nodes {replay_nodes}, want {GRAPH_NODES}")
    for name in ("envtex", "g_buffer", "remat"):
        rows[name] = graph_vs_eager(name, paths[name], smi_line)
    lap("graph: graphed vs eager gradients, times")

    # Memory: the peak of one slice gradient, eager and graphed (a
    # replay), and what the graph pools of the cached keys hold.
    run = lambda: img_grads(lambda: fn(s, SEED), leaves_of(s))
    mem = {}
    for label in ("eager", "graphed"):
        if label == "graphed":
            run()  # captures again: a later key's first call released it
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if label == "eager":
            with graphs.disable():
                run()
        else:
            run()
        torch.cuda.synchronize()
        mem[f"{label}_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    holding = [key[0] for key, b in graphs.cached_bytes().items() if b]
    graphs.clear()
    torch.cuda.empty_cache()
    mem["cache_holds_mib"] = (held - torch.cuda.memory_reserved()) / 2**20
    print(f"[graph] slice gradient peak memory: eager "
          f"{mem['eager_peak_mib']:.1f} MiB, graphed replay "
          f"{mem['graphed_peak_mib']:.1f} MiB; the graph cache's "
          f"{len(holding)} keys with graphs ({', '.join(holding)}) hold "
          f"{mem['cache_holds_mib']:.1f} MiB of reserved memory", flush=True)
    lap("graph: memory")

    # Forward only: render_image's graph.
    fwd = {"max_image_diff": 0.0}
    keep = scene.shapes[0].vertices.detach().clone()
    with torch.no_grad():
        for step, seed in (("seed 11", SEED), ("seed 12", SEED + 1),
                           ("leaf update", SEED + 1)):
            if step == "leaf update":
                scene.shapes[0].vertices.mul_(1.01)
            g = rtt.render_image(scene, opts, seed=seed)
            with graphs.disable():
                e = rtt.render_image(scene, opts, seed=seed)
            diff = float((g - e).abs().max())
            fwd["max_image_diff"] = max(fwd["max_image_diff"], diff)
            print(f"[graph] render_image {step}: max |graphed - eager| "
                  f"{diff:.3e}", flush=True)
            _check(diff <= GRAPH_IMAGE_ATOL,
                   f"render_image {step}: graphed off eager by {diff:.3e}")
        scene.shapes[0].vertices.copy_(keep)
        fwd["graphed_ms"], g_walls = _wall_ms(
            lambda: rtt.render_image(scene, opts, seed=SEED), 5)
        with graphs.disable():
            fwd["eager_ms"], e_walls = _wall_ms(
                lambda: rtt.render_image(scene, opts, seed=SEED), 5)
    print(f"[graph] forward 256x256 4spp: eager median {fwd['eager_ms']:.3f} "
          f"ms (all: {_walls(e_walls)}), graphed median "
          f"{fwd['graphed_ms']:.3f} ms (all: {_walls(g_walls)}); "
          f"{smi_line}", flush=True)
    lap("graph: render_image")

    # The front end's five Adam steps, graphed against eager.
    fe = frontend_slice_scene()
    with graphs.disable():
        e_losses, e_ms = frontend_adam(fe, dev, "graph eager", smi_line)
    g_losses, g_ms = frontend_adam(fe, dev, "graph graphed", smi_line)
    print(f"[graph] front end Adam losses eager {e_losses}, graphed "
          f"{g_losses}; step ms eager {_walls(e_ms)}, graphed "
          f"{_walls(g_ms)}", flush=True)
    _check(np.allclose(g_losses, e_losses, rtol=GRAPH_LOSS_RTOL, atol=0.0),
           "graphed Adam losses differ from eager")
    del fe
    lap("graph: front end Adam")

    batches = graph_batches(paths["slice"])
    lap("graph: kernels vs plain")

    # The continuous gradient (render_image under autograd) and the screen
    # gradient, each its own key and route.
    for name in ("render_image_grad", "screen_gradient"):
        rows[name] = graph_route(name, paths[name], smi_line,
                                 host=name == "screen_gradient")
        lap(f"graph: {name}")
    rows["screen_gradient"]["loop"] = screen_gradient_loop(
        paths["screen_gradient"], SCREEN_ROUNDS, smi_line)
    lap(f"graph: the screen gradient's loop, {SCREEN_ROUNDS} rounds")

    # The device-bound contrast: 1024x1024 x 4 spp.
    (res, spp) = GRAPH_BIG
    big = make_slice_scene(res=res, device=dev)
    o = rtt.RenderOptions(num_samples=spp, max_bounces=1)
    run = lambda: img_grads(lambda: rtt.render(big, o, seed=SEED),
                            slice_leaves(big))
    with graphs.disable():
        big_e, big_e_walls = _wall_ms(run, 1)
    first, _ = _wall_ms(run, 1)
    second, _ = _wall_ms(run, 1)
    big_g, big_g_walls = _wall_ms(run, 1)
    print(f"[graph] {res[0]}x{res[1]} x {spp} spp slice gradient: eager "
          f"{big_e:.3f} ms, graphed {big_g:.3f} ms (first call, eager and "
          f"measured: {first:.3f} ms; second, capture included: "
          f"{second:.3f} ms); {smi_line}", flush=True)
    del big
    graphs.clear()
    torch.cuda.empty_cache()
    lap("graph: 1024x1024")
    return {"paths": rows, "forward": fwd, "memory": mem,
            "batches": batches, "adam_losses": {"eager": e_losses,
                                                "graphed": g_losses},
            "big": {"cell": f"{res[0]}x{res[1]} x {spp} spp",
                    "eager_ms": big_e, "graphed_ms": big_g,
                    "first_call_ms": first, "capture_call_ms": second}}


# ----------------------------------------------------------------------
# Second derivatives through render and render_image
# ----------------------------------------------------------------------

SECOND_ORDER_L2_MAX = 1e-4  # graphed vs graphs.disable(), per leaf


def second_order(fn, scene):
    """The slice leaves' second derivative of fn: g = d sum(fn(scene)^2) /
    d leaves taken with create_graph, then d sum_i <u_i, g_i> / d leaves,
    u_i fixed weights in [0.5, 1.5) made from SEED."""
    leaves = slice_leaves(scene)
    rng = np.random.default_rng(SEED)
    us = [torch.as_tensor(rng.uniform(0.5, 1.5, tuple(x.shape)),
                          dtype=x.dtype, device=x.device) for x in leaves]
    for x in leaves:
        x.requires_grad_(True)
    try:
        img = fn(scene)
        g = torch.autograd.grad(torch.sum(img ** 2), leaves,
                                create_graph=True)
        _check(all(x.requires_grad for x in g),
               "a create_graph gradient has no history")
        total = sum(torch.sum(gi * u) for gi, u in zip(g, us))
        h = torch.autograd.grad(total, leaves, allow_unused=True)
        return [torch.zeros_like(x) if y is None else y.detach()
                for x, y in zip(leaves, h)]
    finally:
        for x in leaves:
            x.requires_grad_(False)


def phase_second_order(scene, opts, smi_line, sharded=None):
    """The slice's second derivative (256x256 x 4 spp) through rtt.render
    and rtt.render_image: the route on the graph cache (the forward
    replays its graph; the backward that records and the continuous
    backward of the marked render run eagerly: graphs.EAGER
    ["create_graph"]) against graphs.disable(), relative L2 <= 1e-4 per
    leaf, printed beside eager against eager; the wall of each (the
    graphed one after the call that captures its forward); the launches
    of the phase.  sharded: label -> sharded_second_order's rows
    ([sharded]'s gloo ranks and one-rank NCCL group), each held against
    the one-process eager second derivative (check_sharded_second_order).
    """
    routes = {"render": lambda s: rtt.render(s, opts, seed=SEED),
              "render_image": lambda s: rtt.render_image(s, opts, seed=SEED)}
    graphs.clear()
    torch.cuda.synchronize()
    reset_launches()
    rows, eager_h = {}, {}
    for name, fn in routes.items():
        eager0 = graphs.EAGER["create_graph"]
        run = lambda: second_order(fn, scene)
        first = run()
        run()  # the forward's capture
        graphed_ms, g_walls = _wall_ms(run, 1)
        routed = graphs.EAGER["create_graph"] - eager0
        with graphs.disable():
            eager = run()
            eager_ms, e_walls = _wall_ms(run, 1)
            again = run()
        l2 = [rel_l2(a, b) for a, b in zip(first, eager)]
        l2_ee = [rel_l2(a, b) for a, b in zip(again, eager)]
        finite = all(bool(torch.isfinite(x).all()) for x in first + eager)
        eager_h[f"{name}_sharded"] = eager
        rows[name] = {"graphed_ms": graphed_ms, "eager_ms": eager_ms,
                      "rel_l2": dict(zip(GRAD_LEAVES, l2)),
                      "rel_l2_eager_vs_eager": dict(zip(GRAD_LEAVES, l2_ee)),
                      "create_graph_routes": routed}
        print(f"[second_order] {name}: relative L2 graphed vs eager per leaf "
              f"{dict(zip(GRAD_LEAVES, l2))}, eager vs eager "
              f"{dict(zip(GRAD_LEAVES, l2_ee))}; wall graphed "
              f"{graphed_ms:.3f} ms, eager {eager_ms:.3f} ms; eager "
              f"create_graph routes taken on the graph cache's route "
              f"{routed} (2 a call of 3: the recording backward and the "
              f"continuous backward of the image); {smi_line}", flush=True)
        _check(finite, f"second order through {name}: non-finite values")
        _check(max(l2) <= SECOND_ORDER_L2_MAX,
               f"second order through {name}: graphed off eager by {l2}")
        _check(routed == 6, f"{name}: {routed} create_graph routes, want 6")
    torch.cuda.synchronize()
    launches = dict(ic.LAUNCHES)
    gathers = note_gather("second_order")
    print(f"[second_order] launches of the phase {launches}; row gathers "
          f"{gathers}", flush=True)
    _check(all(v > 0 for v in launches.values()),
           f"[second_order]: a kernel did not launch: {launches}")
    graphs.clear()
    torch.cuda.empty_cache()
    out = {"routes": rows, "launches": launches}
    if sharded:
        out["sharded"] = check_sharded_second_order(sharded, eager_h,
                                                    smi_line)
    return out


def check_sharded_second_order(runs, refs, smi_line, tag="second_order"):
    """Each sharded second derivative (runs: label -> entry ->
    sharded_second_order row) against one process's eager one (refs:
    entry -> the leaves' second derivatives): finite, relative L2 <=
    SECOND_ORDER_L2_MAX per leaf, the labels that are ranks of one group
    ("... rank r of n") equal, both kernels launched in each first call;
    its wall printed.  Returns label -> entry -> row without "h"."""
    out = {}
    for label, entries in runs.items():
        out[label] = {}
        for name, row in entries.items():
            l2 = [rel_l2(a, b.cpu()) for a, b in zip(row["h"], refs[name])]
            finite = all(bool(torch.isfinite(x).all()) for x in row["h"])
            print(f"[{tag}] {name}, {label}: relative L2 against one "
                  f"process per leaf {dict(zip(GRAD_LEAVES, l2))} (gate "
                  f"{SECOND_ORDER_L2_MAX}); launches of its first call "
                  f"{row['launches']}; wall of a later call "
                  f"{row['ms']:.3f} ms; {smi_line}", flush=True)
            _check(finite, f"{name}, {label}: non-finite second derivative")
            _check(max(l2) <= SECOND_ORDER_L2_MAX,
                   f"{name}, {label}: off one process by {l2}")
            _check(all(v > 0 for v in row["launches"].values()),
                   f"{name}, {label}: a kernel did not launch: "
                   f"{row['launches']}")
            out[label][name] = {"rel_l2": dict(zip(GRAD_LEAVES, l2)),
                                "launches": row["launches"],
                                "ms": row["ms"]}
    groups = {}
    for label, entries in runs.items():
        if " rank " in label:
            groups.setdefault(label.split(" rank ")[0], []).append(entries)
    for group, ranks in groups.items():
        for name in ranks[0]:
            _check(all(torch.equal(a, b) for rk in ranks
                       for a, b in zip(rk[name]["h"], ranks[0][name]["h"])),
                   f"{name}: the {group} ranks' second derivatives differ")
        print(f"[{tag}] {group}: every rank's second derivatives equal",
              flush=True)
    return out


# ----------------------------------------------------------------------
# The row gathers and their scatter-add backward (--gather)
# ----------------------------------------------------------------------

# (site, rows, cols): the gradient cell's tables.
GATHER_TABLES = (("light_intensity", 1, 3), ("mat_const", 3, 3),
                 ("mat_ftab", 3, 12), ("face_pack", 15752, 34))
GATHER_LANES = 65536  # a 256x256 pass


def gather_bound_ms(n, rows, cols):
    """Each input byte read once and each output byte written once at the
    HBM rate, the same both ways: n int64 ids, then the table in and n rows
    out (gather) or n rows of gradients in and the table out (scatter)."""
    return (8 * n + 4 * (n * cols + rows * cols)) / PEAK_HBM_BYTES * 1e3


def _device_ms(fn, calls=10, rounds=5):
    """Device ms a call: `calls` calls captured back to back in one CUDA
    graph (so the host's launches are left out), the graph replayed
    `rounds` times between CUDA events; the median."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(times)


def gather_hit_ids(dev):
    """(triangle ids, material ids) of a 256x256 pass of pixel-centre
    primary rays over the slice scene, in render.swizzle_order."""
    from redner_tpu_torch.render import _swizzle_tensors

    scene = make_slice_scene(device=dev)
    fs = rtt.flatten_scene(scene)
    order, _ = _swizzle_tensors(256, 256, dev)
    with torch.no_grad():
        ray, _ = sample_primary_rays(
            scene.camera, torch.full((GATHER_LANES, 2), 0.5, device=dev),
            pixel_order=order)
        tri = accel.intersect(fs, ray, presorted=True).tri_id
    return tri, fs.face_material_id[tri.clamp(0, fs.num_triangles - 1)]


def site_merges(dev):
    """One eager gradient of the gradient cell's render (slice scene,
    256x256, 4 spp, 1 bounce, edge samplers off; the sphere's vertices and
    material, the light and the camera's position as leaves) with tracing
    on: per table shape, the scatters' launches, variant, lane-columns and
    updates (their ratio is the merge factor)."""
    opts = rtt.RenderOptions(num_samples=4, max_bounces=1,
                             use_primary_edge_sampling=False,
                             use_secondary_edge_sampling=False)
    scene = make_slice_scene(device=dev)
    leaves = [scene.shapes[0].vertices, scene.area_lights[0].intensity,
              scene.materials[0].diffuse_reflectance.texels,
              scene.materials[0].specular_reflectance.texels,
              scene.materials[0].roughness.texels, scene.camera.position]
    sites = {}
    wrapped = gcu.scatter_kernel

    def counted(src, idx, rows):
        torch.cuda.synchronize()
        before = gcu.work_counts()
        out = wrapped(src, idx, rows)
        torch.cuda.synchronize()
        after = gcu.work_counts()
        key = f"{rows}x{src.shape[-1]}"
        row = sites.setdefault(key, {
            "variant": gcu.scatter_variant(rows, src.shape[-1],
                                          src.element_size()),
            "launches": 0, "lane_cols": 0, "updates": 0})
        row["launches"] += 1
        row["lane_cols"] += after[0] - before[0]
        row["updates"] += after[1] - before[1]
        return out

    from redner_tpu_torch import timing

    for x in leaves:
        x.requires_grad_(True)
    gcu.scatter_kernel = counted
    timing.set_tracing(True)
    try:
        with graphs.disable():
            img = rtt.render(scene, opts, seed=SEED)
            torch.autograd.grad(img.sum(), leaves)
        torch.cuda.synchronize()
    finally:
        timing.set_tracing(False)
        timing.clear()
        gcu.scatter_kernel = wrapped
        for x in leaves:
            x.requires_grad_(False)
    for row in sites.values():
        row["merge"] = row["lane_cols"] / max(row["updates"], 1)
    return sites


def warp_variant(fn):
    """fn() with every scatter_kernel on the warp variant, whatever the
    table's size: what the small tables' block variant saves."""
    chosen = gcu.scatter_variant
    gcu.scatter_variant = lambda rows, cols, itemsize: "warp"
    try:
        return fn()
    finally:
        gcu.scatter_variant = chosen


def phase_gather(smi_line):
    """gather_rows and scatter_rows at the gradient cell's shapes (65,536
    lanes; the light, material and face tables; ids all equal, the slice
    scene's hit record in swizzled order, and random ones out of range
    included): each kernel against its plain version (the gather bit for
    bit, the scatter within 1e-5 of the float64 sum's largest value), then
    device times (_device_ms: calls back to back in a CUDA graph, warm L2)
    of the kernels, the plain versions and, as yardsticks the port never
    calls, index_put_(accumulate=True) and index_add_ on a zeroed table,
    and the eager scatter call (host and device); for the tables of the
    block variant, the warp variant on the same inputs too (checked and
    timed alike); the bound; the merge factor at each site of one eager
    gradient of the cell's render; and the launches of each route the
    full script drove before this phase (GATHER_ROUTES)."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib_path, log = gcu.build(verbose=True)
    gcu._lib()
    print(f"[gather] nvcc -> {os.path.relpath(lib_path, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in log.strip().splitlines():
        print(f"[gather] {line}")
    tri, mid = gather_hit_ids(dev)
    rng = torch.Generator(device=dev).manual_seed(SEED)
    rows_out = []
    for site, rows, cols in GATHER_TABLES:
        table = torch.randn((rows, cols), generator=rng, device=dev)
        src = torch.randn((GATHER_LANES, cols), generator=rng, device=dev)
        for kind in ("hits", "equal", "random"):
            if kind == "hits":
                idx = tri if rows > 3 else mid
            elif kind == "equal":
                idx = torch.zeros_like(tri)
            else:
                idx = torch.randint(-2, rows + 2, (GATHER_LANES,),
                                    generator=rng, device=dev)
            gcu.reset_launch_counts()
            out = gcu.gather_kernel(table, idx)
            got = gcu.scatter_kernel(src, idx, rows)
            want = gcu.scatter_plain(src.double(), idx, rows)
            _check(torch.equal(out, gcu.gather_plain(table, idx)),
                   f"{site}/{kind}: the gather differs from table[idx]")
            err = float((got.double() - want).abs().max()) / max(
                float(want.abs().max()), 1e-30)
            _check(err <= 1e-5, f"{site}/{kind}: the scatter is off the "
                   f"float64 sum by {err:.3g} of its largest value")
            variant = gcu.scatter_variant(rows, cols, 4)
            _check(gcu.LAUNCHES["scatter_rows." + variant] == 1,
                   f"{site}/{kind}: launches {gcu.LAUNCHES}")
            ic_ = idx.clamp(0, rows - 1)
            zero = torch.zeros((rows, cols), device=dev)
            row = {
                "site": site, "rows": rows, "cols": cols, "ids": kind,
                "variant": variant, "rel_err": err,
                "gather_ms": _device_ms(lambda: gcu.gather_kernel(table, idx)),
                "gather_plain_ms": _device_ms(
                    lambda: gcu.gather_plain(table, idx)),
                "scatter_ms": _device_ms(
                    lambda: gcu.scatter_kernel(src, idx, rows)),
                "scatter_plain_ms": _device_ms(
                    lambda: gcu.scatter_plain(src, idx, rows)),
                "index_put_ms": _device_ms(lambda: zero.index_put_(
                    (ic_,), src, accumulate=True)),
                "index_add_ms": _device_ms(
                    lambda: zero.index_add_(0, ic_, src)),
                "scatter_eager_ms": time_cuda(
                    lambda: gcu.scatter_kernel(src, idx, rows), 50,
                    rounds=3)[0],
                "bound_ms": gather_bound_ms(GATHER_LANES, rows, cols)}
            if variant == "block":
                got_w = warp_variant(lambda: gcu.scatter_kernel(
                    src, idx, rows))
                err_w = float((got_w.double() - want).abs().max()) / max(
                    float(want.abs().max()), 1e-30)
                _check(err_w <= 1e-5, f"{site}/{kind}: the warp variant is "
                       f"off the float64 sum by {err_w:.3g}")
                row["warp_scatter_ms"] = warp_variant(lambda: _device_ms(
                    lambda: gcu.scatter_kernel(src, idx, rows)))
                print(f"[gather] {site} {rows}x{cols}, ids {kind}: warp "
                      f"variant (not chosen) {row['warp_scatter_ms']:.5f} "
                      f"device ms a call (graphed) against the block "
                      f"variant's {row['scatter_ms']:.5f}; rel err "
                      f"{err_w:.3g}", flush=True)
            rows_out.append(row)
            print(f"[gather] {site} {rows}x{cols}, ids {kind}: {variant}; "
                  f"device ms a call (graphed): scatter "
                  f"{row['scatter_ms']:.5f} (plain "
                  f"{row['scatter_plain_ms']:.5f}, index_put_ "
                  f"{row['index_put_ms']:.5f}, index_add_ "
                  f"{row['index_add_ms']:.5f}), gather "
                  f"{row['gather_ms']:.5f} (plain "
                  f"{row['gather_plain_ms']:.5f}); bound "
                  f"{row['bound_ms']:.5f} (bytes), scatter time / bound "
                  f"{row['scatter_ms'] / row['bound_ms']:.2f}; eager "
                  f"scatter call {row['scatter_eager_ms']:.5f} ms; rel err "
                  f"{err:.3g}; {smi_line}", flush=True)
    sites = site_merges(dev)
    for key, row in sorted(sites.items()):
        print(f"[gather] site {key}: {row['launches']} {row['variant']} "
              f"scatters, {row['lane_cols']} lane-columns, "
              f"{row['updates']} updates: merge factor "
              f"{row['merge']:.1f}", flush=True)
    for route, counts in GATHER_ROUTES.items():
        print(f"[gather] route {route}: launches {counts}", flush=True)
    return {"tables": rows_out, "sites": sites,
            "routes": dict(GATHER_ROUTES)}


def gather_main():
    """--gather: the build, the device line and phase_gather alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    phase_build()
    smi_line = phase_device()
    out = phase_gather(smi_line)
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"gather": out}))
    return 0


# ----------------------------------------------------------------------
# The tutorials' inverse-rendering loops (tutorials/torch_port)
# ----------------------------------------------------------------------

# (file, steps a level): each at its own size (64x64; 05: 32x32 then 64x64)
TUTORIALS = (("01_optimize_single_triangle", 6), ("02_pose_estimation", 6),
             ("03_material_texture", 6), ("04_fast_deferred_rendering", 6),
             ("05_coarse_to_fine_estimation", 4),
             ("01_optimize_single_triangle_compat", 6))
TUTORIAL_LOSS_RTOL = 1e-3  # graphed vs graphs.disable() losses


def load_tutorial(name):
    """The module of tutorials/torch_port/<name>.py."""
    import importlib.util

    path = os.path.join(ROOT, "tutorials", "torch_port", name + ".py")
    spec = importlib.util.spec_from_file_location(f"tutorial_{name[:2]}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _levels(losses):
    """A tutorial's losses by level (05 returns one list a level)."""
    return losses if isinstance(losses[0], list) else [losses]


def phase_tutorials(smi_line):
    """Each tutorial of tutorials/torch_port on the card for a few steps at
    its own size: its launch counts zeroed just before the graphed run and
    read after it, the graphs it captured and replayed, the wall of each
    step, and its losses: finite, falling over each level, and within rtol
    1e-3 of the same steps inside graphs.disable()."""
    rows = {}
    for name, steps in TUTORIALS:
        mod = load_tutorial(name)
        graphs.clear()
        torch.cuda.synchronize()
        reset_launches()
        cap0, rep0 = dict(graphs.CAPTURES), dict(graphs.REPLAYS)
        eager0 = graphs.EAGER["memory"]
        got = mod.main(steps=steps)
        torch.cuda.synchronize()
        launches = dict(ic.LAUNCHES)
        note_gather(f"tutorials.{name}")
        captures = {k: graphs.CAPTURES[k] - cap0[k] for k in cap0}
        replays = {k: graphs.REPLAYS[k] - rep0[k] for k in rep0}
        with graphs.disable():
            ref = mod.main(steps=steps)
        g_levels, e_levels = _levels(got["losses"]), _levels(ref["losses"])
        g_ms = [ms for lv in _levels(got["step_ms"]) for ms in lv[2:]]
        e_ms = [ms for lv in _levels(ref["step_ms"]) for ms in lv[2:]]
        flat_g = [x for lv in g_levels for x in lv]
        flat_e = [x for lv in e_levels for x in lv]
        rows[name] = {
            "steps": steps, "losses": g_levels, "eager_losses": e_levels,
            "step_ms": statistics.median(g_ms),
            "eager_step_ms": statistics.median(e_ms),
            "first_step_ms": [lv[:2] for lv in _levels(got["step_ms"])],
            "captures": captures, "replays": replays,
            "memory_eager": graphs.EAGER["memory"] - eager0,
            "launches": launches}
        print(f"[tutorials] {name}: {steps} steps a level; losses graphed "
              f"{g_levels}, eager {e_levels}; step ms graphed median "
              f"{rows[name]['step_ms']:.3f} (all after the first two of a "
              f"level: {_walls(g_ms)}; the first two, eager then the "
              f"captures: {rows[name]['first_step_ms']}), eager "
              f"median {rows[name]['eager_step_ms']:.3f} (all: "
              f"{_walls(e_ms)}); captures {captures}, replays {replays}; "
              f"launches of the graphed run {launches}; {smi_line}",
              flush=True)
        _check(all(np.isfinite(flat_g + flat_e)), f"{name}: a loss is not "
               "finite")
        _check(all(lv[-1] < lv[0] for lv in g_levels),
               f"{name}: the loss did not fall over a level: {g_levels}")
        _check(np.allclose(flat_g, flat_e, rtol=TUTORIAL_LOSS_RTOL, atol=0.0),
               f"{name}: graphed losses {flat_g} off eager {flat_e}")
        _check(launches["closest_hit"] > 0,
               f"{name}: the closest-hit kernel did not launch: {launches}")
        _check(launches["any_hit"] > 0 or name.startswith("04"),
               f"{name}: the any-hit kernel did not launch: {launches}")
        _check(captures["forward"] > 0 and replays["forward"] > 0,
               f"{name}: no graph captured or replayed: {captures}, "
               f"{replays}")
    graphs.clear()
    torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------------
# Peak device memory of the gradient, with and without remat (--memory)
# ----------------------------------------------------------------------

MEMORY_CELLS = (((256, 256), 4), ((1024, 1024), 16), ((1024, 1024), 32))
ONE_RUN = 1 << 62  # edge.CANDIDATE_CHUNK that keeps every lane in one run


def _record_history(on):
    """torch.cuda.memory._record_memory_history with python stacks, or
    False where this torch does not take these arguments."""
    try:
        if on:
            torch.cuda.memory._record_memory_history(
                enabled="all", context="alloc", stacks="python",
                max_entries=4_000_000)
        else:
            torch.cuda.memory._record_memory_history(enabled=None)
        return True
    except (TypeError, RuntimeError) as e:
        print(f"[memory] allocation history not measured: {e}", flush=True)
        return False


def _peak_sites(baseline, top=10):
    """Replays the recorded allocation trace to its peak -> (peak bytes,
    [(bytes, count, site)]) of the blocks live at the peak, by the
    innermost line of the port (or of this script) that allocated them,
    with the port's functions above it."""
    trace = torch.cuda.memory._snapshot()["device_traces"][0]
    live, cur, best, at_best = {}, baseline, baseline, {}
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
            if cur > best:
                best, at_best = cur, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])["size"]
    sites = {}
    for ev in at_best.values():
        ours = [f for f in ev.get("frames", ())
                if "redner_tpu_torch" in f["filename"]
                or f["filename"].endswith("chip_smoke.py")]
        site = " < ".join(
            f"{f['filename'].split('redner_tpu_torch/')[-1].split('/')[-1]}"
            f":{f['line']} {f['name']}" for f in ours[:3]) or "(no port frame)"
        n, b = sites.get(site, (0, 0))
        sites[site] = (n + 1, b + ev["size"])
    rows = sorted(((b, n, site) for site, (n, b) in sites.items()),
                  reverse=True)[:top]
    return best, rows


def phase_memory(smi_line):
    """The slice's fwd+bwd at MEMORY_CELLS, live and remat, with the
    secondary-edge candidate draw in runs (edge.CANDIDATE_CHUNK) and in one
    run: peak device memory (max_memory_allocated over one gradient, after
    empty_cache) and wall time; a cell that runs out of memory prints OOM.
    Then, at 256x256 and at 1024x1024 x 16 spp, the allocations live at the
    peak by the line that made them (recorded allocation history)."""
    from redner_tpu_torch import edge as tedge

    chunk = tedge.CANDIDATE_CHUNK
    gradient(make_slice_scene(res=(64, 64), device="cuda"),
             rtt.RenderOptions(num_samples=4, max_bounces=1))  # warm-up
    rows = []
    for res, spp in MEMORY_CELLS:
        scene = make_slice_scene(res=res, device="cuda")
        for runs in ("runs",) if spp == 32 else ("runs", "one run"):
            tedge.CANDIDATE_CHUNK = chunk if runs == "runs" else ONE_RUN
            for remat in (False, True):
                o = rtt.RenderOptions(num_samples=spp, max_bounces=1,
                                      remat=remat)
                label = (f"{res[0]}x{res[1]} {spp}spp "
                         f"{'remat' if remat else 'live'}, candidate draw "
                         f"in {runs}")
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                try:
                    g = gradient(scene, o)
                    torch.cuda.synchronize()
                    ok = all(bool(torch.isfinite(x).all()) for x in g)
                    _check(ok, f"{label}: non-finite gradient")
                    peak = torch.cuda.max_memory_allocated() / 2**20
                    ms = (time.perf_counter() - t0) * 1e3
                    del g
                except torch.cuda.OutOfMemoryError:
                    peak = ms = None
                torch.cuda.empty_cache()
                rows.append({"res": list(res), "spp": spp, "remat": remat,
                             "candidate_runs": runs == "runs",
                             "peak_mib": peak, "gradient_ms": ms,
                             "base_mib": base / 2**20})
                print(f"[memory] {label}: " + (
                    "OOM" if peak is None else
                    f"peak {peak:.1f} MiB (scene and earlier tensors "
                    f"{base / 2**20:.1f} MiB), fwd+bwd {ms:.1f} ms")
                    + f"; {smi_line}", flush=True)
        tedge.CANDIDATE_CHUNK = chunk
        if spp == 32:
            continue
        for remat in (False, True):
            o = rtt.RenderOptions(num_samples=spp, max_bounces=1, remat=remat)
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            if not _record_history(True):
                break
            try:
                gradient(scene, o)
                torch.cuda.synchronize()
                peak, sites = _peak_sites(base)
            finally:
                _record_history(False)
            print(f"[memory] {res[0]}x{res[1]} {spp}spp "
                  f"{'remat' if remat else 'live'}: {peak / 2**20:.1f} MiB "
                  f"live at the peak of the recorded trace; by site:",
                  flush=True)
            for b, n, site in sites:
                print(f"[memory]   {b / 2**20:10.1f} MiB {n:6d} blocks  "
                      f"{site}", flush=True)
        del scene
    print(json.dumps({"memory": rows}), flush=True)
    return rows


# (label, resolution, spp, the leaves of the gradient, calls): the
# sequence graphed_memory runs with no clear() between its 1024x1024 calls.
GRAPH_MEMORY_CALLS = (
    ("256x256 x 4 spp, every leaf", (256, 256), 4, None, 3),
    ("1024x1024 x 16 spp, every leaf", (1024, 1024), 16, None, 3),
    ("1024x1024 x 16 spp, the vertices", (1024, 1024), 16, 1, 2),
    ("1024x1024 x 32 spp, every leaf", (1024, 1024), 32, None, 2),
    ("1024x1024 x 16 spp, the vertices", (1024, 1024), 16, 1, 1),
    ("1024x1024 x 32 spp, every leaf", (1024, 1024), 32, None, 1))


def graphed_memory(smi_line):
    """The slice's gradient through the graph cache (rtt.render), live, in
    the sequence GRAPH_MEMORY_CALLS: each key's first call runs eagerly
    (measured), its second captures, later ones replay; a key whose
    graphs would not fit the card runs eagerly from its second call on
    (graphs.EAGER["memory"]).  256x256 alone first; then, with no clear()
    between them, a 1024x1024 x 16 spp key, a second one (the gradient
    w.r.t. the sphere's vertices alone), whose first call releases the
    first key's graphs, the 32 spp key, which runs eagerly beside what
    the cache holds, the second 16 spp key again (it captures again) and
    the 32 spp key again (its eager run releases that key's graphs
    first).  Per call: its wall and peak, the captures and eager calls
    it made, and the bytes each cached key keeps after it (the cache's
    count) beside the reserved memory.  No call may run out of memory."""
    rows = []
    scenes = {}
    graphs.clear()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    for label, res, spp, n_leaves, calls in GRAPH_MEMORY_CALLS:
        if res not in scenes:
            scenes.clear()
            graphs.clear()
            torch.cuda.empty_cache()
            scenes[res] = make_slice_scene(res=res, device="cuda")
        scene = scenes[res]
        o = rtt.RenderOptions(num_samples=spp, max_bounces=1)
        leaves = slice_leaves(scene)[:n_leaves]
        for call in range(calls):
            cap0, eager0 = dict(graphs.CAPTURES), graphs.EAGER["memory"]
            torch.cuda.reset_peak_memory_stats()
            for x in leaves:
                x.requires_grad_(True)
            try:
                t0 = time.perf_counter()
                g = torch.autograd.grad(
                    rtt.render(scene, o, seed=SEED).sum(), leaves)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            finally:
                for x in leaves:
                    x.requires_grad_(False)
            _check(all(bool(torch.isfinite(x).all()) for x in g),
                   f"graphed memory, {label}: non-finite gradient")
            del g
            torch.cuda.empty_cache()
            kept = [b / 2**20 for b in graphs.cached_bytes().values()]
            row = {"key": label, "call": call, "ms": ms,
                   "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                   "captures": {k: graphs.CAPTURES[k] - cap0[k]
                                for k in cap0},
                   "eager_by_memory": graphs.EAGER["memory"] - eager0,
                   "keys_cached": len(kept),
                   "kept_mib": sorted(kept),
                   "reserved_mib": (torch.cuda.memory_reserved() - base)
                   / 2**20}
            rows.append(row)
            print(f"[memory] graph cache, {label}, call {call + 1}: "
                  f"{ms:.1f} ms, peak {row['peak_mib']:.1f} MiB; captures "
                  f"{row['captures']}, eager by memory "
                  f"{row['eager_by_memory']}; {len(kept)} key(s) cached, "
                  f"keeping {[round(b, 1) for b in row['kept_mib']]} MiB "
                  f"(reserved {row['reserved_mib']:.1f} MiB); {smi_line}",
                  flush=True)
    by = lambda i, c: rows[sum(n for *_, n in GRAPH_MEMORY_CALLS[:i]) + c]
    _check(all(by(i, 1)["captures"]["backward"] == 1 for i in (0, 1, 2)),
           "a 16 spp or 256x256 key did not capture at its second call")
    _check(by(2, 0)["kept_mib"][-1] == 0.0 and by(2, 1)["kept_mib"].count(
        0.0) == 1, "the second 16 spp key did not evict the first")
    _check(by(3, 1)["eager_by_memory"] == 2,
           "the 32 spp key captured; the cache predicted it would not fit")
    _check(by(4, 0)["captures"]["backward"] == 1
           and by(5, 0)["eager_by_memory"] == 2
           and all(b == 0.0 for b in by(5, 0)["kept_mib"]),
           "the 32 spp key's eager call did not release the 16 spp graphs")
    graphs.clear()
    scenes.clear()
    torch.cuda.empty_cache()
    print(json.dumps({"memory_graphed": rows}), flush=True)
    return rows


def memory_main(eager=True):
    """--memory: phase_memory (eager) then graphed_memory; --graph-memory:
    graphed_memory alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    phase_build()
    smi_line = phase_device()
    if eager:
        with graphs.disable():
            phase_memory(smi_line)
    graphed_memory(smi_line)
    print(smi_line)
    return 0


# ----------------------------------------------------------------------
# The lane split over several cards (--cards N)
# ----------------------------------------------------------------------


def phase_cards(world, smi_lines):
    """The slice's gradient split over `world` ranks, one card each (NCCL),
    against one process on the first card, per CARDS_CELLS cell
    (resolution, spp), both replaying graphs (the ranks' with their
    collectives captured): pixels within atol 1e-6, each leaf's gradient
    within relative L2 1e-4, the ranks' gradients equal; kernel nodes (at
    capture) and peak memory per rank; fwd+bwd of one graphed card
    against the ranks' (the slowest rank's, median of 3).  Returns the
    rows for the JSON line."""
    dev = torch.device("cuda", 0)
    lap = _Lap(time.perf_counter())
    refs = []
    for res, spp in CARDS_CELLS:
        scene = make_slice_scene(res=res, device=dev)
        refs.append(gradient_run(
            scene, rtt.RenderOptions(num_samples=spp, max_bounces=1)))
        del scene
        lap(f"cards: one process {res[0]}x{res[1]} x {spp} spp")
    scene = make_slice_scene(res=SLICE_CELL[0], device=dev)
    so_opts = rtt.RenderOptions(num_samples=SLICE_CELL[1], max_bounces=1)
    with graphs.disable():
        so_refs = {
            "render_sharded": second_order(
                lambda s: rtt.render(s, so_opts, seed=SEED), scene),
            "render_image_sharded": second_order(
                lambda s: rtt.render_image(s, so_opts, seed=SEED), scene)}
    del scene
    lap("cards: one process, second derivatives")
    torch.cuda.empty_cache()

    ranks = spawn_ranks(world, [f"cuda:{r}" for r in range(world)],
                        CARDS_CELLS, False, "nccl", mixed=True)
    lap(f"cards: {world} ranks (spawned)")

    rows = []
    for i, ((res, spp), ref) in enumerate(zip(CARDS_CELLS, refs)):
        cell = f"{res[0]}x{res[1]} x {spp} spp"
        per_rank = [r_[i] for r_ in ranks]
        _compare_ranks("cards", cell, per_rank, ref)
        slowest = [max(w) for w in zip(*(out["walls"] for out in per_rank))]
        _check(ref["graphed"] and all(out["graphed"] for out in per_rank),
               f"{cell}: a run did not replay graphs")
        row = {"cell": cell, "world": world, "graphed": True,
               "gradient_ms_one_process": ref["ms"],
               "gradient_ms_ranks": statistics.median(slowest),
               "launches_one_process": ref["launches"],
               "launches_per_rank": [out["launches"] for out in per_rank],
               "peak_mib_one_process": ref["peak_mib"],
               "peak_mib_per_rank": [out["peak_mib"] for out in per_rank]}
        rows.append(row)
        print(f"[cards] {cell}, graphed: fwd+bwd one card median "
              f"{ref['ms']:.3f} ms (all: {_walls(ref['walls'])}); {world} "
              f"ranks, one card each (slowest rank) median "
              f"{row['gradient_ms_ranks']:.3f} ms (all: {_walls(slowest)}); "
              f"kernel nodes one card {ref['launches']}, per rank "
              f"{row['launches_per_rank'][0]}; peak MiB one process "
              f"{ref['peak_mib']}, per rank {row['peak_mib_per_rank']}",
              flush=True)
    rows.append(check_mixed_routes(
        [r_[-2] for r_ in ranks], refs[CARDS_CELLS.index(SLICE_CELL)]))
    rows.append(check_mixed_second_order([r_[-1] for r_ in ranks], so_refs))
    for line in smi_lines:
        print(f"[cards] {line}", flush=True)
    return rows


def check_mixed_routes(ranks, ref):
    """mixed_routes' rows of each rank against one process's gradient
    (ref, at SLICE_CELL): at every call each rank took the route its
    emptied cache gives (eager, capture, replay), the ranks' gradients
    are equal and each within SHARD_L2_MAX relative L2 of ref.  Returns
    the row for the JSON line."""
    none, both = {"forward": 0, "backward": 0}, {"forward": 1, "backward": 1}
    routes = []
    for call in range(MIXED_CALLS):
        got = [out[call] for out in ranks]
        since = _mixed_since(call, len(ranks))
        routes.append([("eager", "capture", "replay")[min(n, 2)]
                       for n in since])
        want = [both if n == 1 else none for n in since]
        l2 = max(rel_l2(a, b) for out in got
                 for a, b in zip(out["grads"], ref["grads"]))
        print(f"[cards] mixed routes, call {call + 1}: routes by rank "
              f"{routes[-1]}, captures {[out['captures'] for out in got]}; "
              f"max relative L2 against one process {l2:.3e} (gate "
              f"{SHARD_L2_MAX})", flush=True)
        _check([out["captures"] for out in got] == want,
               f"mixed routes, call {call + 1}: captures "
               f"{[out['captures'] for out in got]}, want {want}")
        _check(l2 <= SHARD_L2_MAX, f"mixed routes, call {call + 1}: "
               f"relative L2 {l2}")
        _check(all(torch.equal(a, b) for out in got
                   for a, b in zip(out["grads"], got[0]["grads"])),
               f"mixed routes, call {call + 1}: the ranks' gradients differ")
    return {"cell": "mixed routes", "routes": routes}


def _mixed_since(call, world):
    """Each rank's calls since its graph cache was emptied (mixed_routes:
    rank r empties it before call r + 1)."""
    return [call if call <= r else call - r - 1 for r in range(world)]


def check_mixed_second_order(ranks, refs):
    """mixed_second_order's rows of each rank against one process's
    second derivatives (refs: entry -> leaves' second derivatives, eager):
    at every call each rank's forwards took the route its emptied cache
    gives (two forward captures at a key's second call; the backwards,
    which record, run eagerly and capture nothing), the ranks' second
    derivatives are equal, finite and each within SECOND_ORDER_L2_MAX
    relative L2 of refs.  Returns the row for the JSON line."""
    routes = []
    for call in range(MIXED_CALLS):
        got = [out[call] for out in ranks]
        since = _mixed_since(call, len(ranks))
        routes.append([("eager", "capture", "replay")[min(n, 2)]
                       for n in since])
        want = [{"forward": 2 if n == 1 else 0, "backward": 0}
                for n in since]
        l2 = max(rel_l2(a, b.cpu()) for out in got
                 for name in SHARDED_SECOND_ORDER
                 for a, b in zip(out["h"][name], refs[name]))
        print(f"[cards] mixed routes, second derivatives, call {call + 1}: "
              f"forward routes by rank {routes[-1]}, captures "
              f"{[out['captures'] for out in got]}; max relative L2 "
              f"against one process {l2:.3e} (gate {SECOND_ORDER_L2_MAX})",
              flush=True)
        _check([out["captures"] for out in got] == want,
               f"mixed second derivatives, call {call + 1}: captures "
               f"{[out['captures'] for out in got]}, want {want}")
        _check(all(bool(torch.isfinite(x).all()) for out in got
                   for name in SHARDED_SECOND_ORDER for x in out["h"][name]),
               f"mixed second derivatives, call {call + 1}: non-finite")
        _check(l2 <= SECOND_ORDER_L2_MAX, f"mixed second derivatives, call "
               f"{call + 1}: relative L2 {l2}")
        _check(all(torch.equal(a, b) for out in got
                   for name in SHARDED_SECOND_ORDER
                   for a, b in zip(out["h"][name], got[0]["h"][name])),
               f"mixed second derivatives, call {call + 1}: the ranks' "
               "second derivatives differ")
    return {"cell": "mixed routes, second derivatives", "routes": routes}


def cards_main(world):
    """`python3 chip_smoke.py --cards N`: phase_cards on N cards."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs CUDA cards", file=sys.stderr)
        return 1
    _check(torch.cuda.device_count() >= world,
           f"--cards {world}: {torch.cuda.device_count()} cards visible")
    t_start = time.perf_counter()
    phase_build()
    smi_line = phase_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    rows = phase_cards(world, smi.stdout.strip().splitlines())
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"cards": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class _Lap:
    """Prints the seconds each phase took, on the host clock."""

    def __init__(self, t0):
        self.t = t0

    def __call__(self, what):
        now = time.perf_counter()
        print(f"[timing] {what}: {now - self.t:.1f} s", flush=True)
        self.t = now


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
    lap = _Lap(t_start)
    lap("build, device, kernels")
    with graphs.disable():  # the phases of the eager render
        launches = phase_render(scene, opts)
        lap("render")
        fwd_ms, per = phase_times(fs, scene, opts)
        lap("times")
        sets = phase_sets(fs, scene, dev)
        lap("sets")
        grad_launches, grad_rows, grad_ms = phase_grad(scene, opts, smi_line)
        lap("grad")
        env_fwd, env_grad, env_shadow, env_fwd_ms, env_grad_ms = (
            phase_envtex(opts, smi_line))
        lap("envtex")
        aov_rows, aov_big = phase_aov(smi_line)
        lap("aov")
        files_row, loaded, loaded_cpu = phase_files(opts, smi_line)
        lap("files")
        cam_rows = phase_cameras(loaded, loaded_cpu, opts, smi_line)
        lap("cameras")
        fe_rows = phase_frontend(scene, opts, smi_line)
        lap("frontend")
    shard_row = phase_sharded(scene, opts, smi_line)
    lap("sharded")
    graph_row = phase_graph(scene, opts, smi_line)
    lap("graph")
    so_row = phase_second_order(scene, opts, smi_line,
                                shard_row.pop("second_order"))
    lap("second_order")
    tut_rows = phase_tutorials(smi_line)
    lap("tutorials")
    gather_row = phase_gather(smi_line)
    lap("gather")

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
            "ray_sets": {k.split("/")[0]: v for k, v in sets.items()
                         if k.endswith(kind)},
            "launches_per_gradient": grad_launches[kind],
            "gradient_ms": grad_ms,
            "edge_pairs": {name: {k: r[k] for k in ("ms", "plain_ms",
                                                    "bound_ms")}
                           for name, r in grad_rows.items()
                           if r["kind"] == kind},
            "envtex": {"launches": env_fwd[kind],
                       "launches_per_gradient": env_grad[kind],
                       "forward_ms": env_fwd_ms, "gradient_ms": env_grad_ms},
        })
        kernels[-1]["aov"] = {
            name: {k: (v[kind] if k.startswith("launches") else v)
                   for k, v in row.items()}
            for name, row in aov_rows.items()}
        kernels[-1]["files"] = {
            k: (v[kind] if k.startswith("launches") else v)
            for k, v in files_row.items()}
        kernels[-1]["cameras"] = {
            name: {k: (v[kind] if k.startswith("launches") else v)
                   for k, v in row.items() if k != "camera_batch"}
            for name, row in cam_rows.items()}
        for mode in ("frontend", "replay", "remat"):
            kernels[-1][mode] = {
                k: (v[kind] if k.startswith("launches") else v)
                for k, v in fe_rows[mode].items()
                if k not in ("adam_step_ms", "adam_losses")}
        kernels[-1]["frontend"]["adam_step_ms"] = fe_rows["frontend"][
            "adam_step_ms"]
        kernels[-1]["sharded"] = {
            "launches_per_rank": [x[kind] for x in
                                  shard_row["launches_per_rank"]],
            "launches_one_rank_nccl": shard_row["launches_one_rank_nccl"][
                kind],
            **{k: shard_row[k] for k in (
                "peak_mib_per_rank", "peak_mib_one_process",
                "gradient_ms_one_process", "gradient_ms_two_ranks")},
            "nccl_graphed": {
                **shard_row["nccl_graphed"],
                "nodes_total": shard_row["nccl_graphed"]["nodes_total"][kind]},
            "nccl_train": shard_row["nccl_train"]}
        kernels[-1]["graph"] = {
            "nodes_per_gradient": GRAPH_NODES[kind],
            "nodes_per_forward": graph_row["paths"]["slice"]["nodes"][
                "forward"][kind],
            "replay_nodes_profiled": graph_row["paths"]["slice"].get(
                "replay_nodes", {}).get(kind),
            "gradient_ms": {name: {k: row.get(k) for k in (
                "eager_ms", "graphed_ms", "capture_s", "max_image_diff",
                "max_rel_l2", "busy_ms", "idle")}
                for name, row in graph_row["paths"].items()},
            "forward_ms": {k: graph_row["forward"][k]
                           for k in ("eager_ms", "graphed_ms")},
            "idle": graph_row["paths"]["slice"].get("idle"),
            "route_nodes": {name: row["nodes_total"][kind]
                            for name, row in graph_row["paths"].items()
                            if "nodes_total" in row},
            "memory": graph_row["memory"], "big": graph_row["big"]}
        kernels[-1]["second_order"] = {
            "launches": so_row["launches"][kind],
            **{name: {k: row[k] for k in ("graphed_ms", "eager_ms")}
               for name, row in so_row["routes"].items()},
            "sharded": {label: {name: {"launches": r["launches"][kind],
                                       "ms": r["ms"]}
                                for name, r in entries.items()}
                        for label, entries in so_row["sharded"].items()}}
        kernels[-1]["tutorials"] = {
            name: {"launches": row["launches"][kind],
                   "step_ms": row["step_ms"],
                   "eager_step_ms": row["eager_step_ms"]}
            for name, row in tut_rows.items()}
        if kind == "any_hit":
            kernels[-1]["envtex"]["envmap_shadow_batch"] = {
                k: env_shadow[k] for k in ("ms", "plain_ms", "bound_ms")}
        else:
            kernels[-1]["aov"]["deferred_batch_262144"] = {
                k: aov_big[k] for k in ("ms", "plain_ms", "bound_ms")}
            for name in ("fisheye", "panorama"):
                kernels[-1]["cameras"][name]["camera_batch"] = {
                    k: cam_rows[name]["camera_batch"][k]
                    for k in ("dead_share", "ms", "plain_ms", "bound_ms")}
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"gather": gather_row}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--screen-rounds"] and len(sys.argv) == 3:
        SCREEN_ROUNDS = int(sys.argv[2])
        sys.exit(main())
    if sys.argv[1:] == ["--gather"]:
        sys.exit(gather_main())
    if sys.argv[1:] == ["--memory"]:
        sys.exit(memory_main())
    if sys.argv[1:] == ["--graph-memory"]:
        sys.exit(memory_main(eager=False))
    if sys.argv[1:2] == ["--cards"] and len(sys.argv) == 3:
        sys.exit(cards_main(int(sys.argv[2])))
    sys.exit(main())
