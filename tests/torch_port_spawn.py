"""Scenes and per-rank work for the port's sharding tests, which run it on
gloo ranks (redner_tpu_torch.parallel.spawn.run_ranks).

torch.multiprocessing.spawn re-imports the module of the function it runs
in every child, so this module imports torch and the port only, never JAX.
"""

import importlib

import numpy as np
import torch

import redner_tpu_torch as rtt
from redner_tpu_torch import edge as tedge
from redner_tpu_torch.core import shardutil
from redner_tpu_torch.ops import intersect_cuda as ic
from redner_tpu_torch.parallel.sharding import (make_mesh, make_train_step,
                                                render_image_sharded,
                                                render_sharded)


def single_triangle(res=(16, 16), diffuse=(0.5, 0.5, 0.5)):
    """tests/scene_util.single_triangle_scene, built with the port on the
    CPU: one gray triangle lit by a quad area light behind the camera."""
    dev = "cpu"
    cam = rtt.make_camera(position=[0.0, 0.0, -5.0], look_at=[0.0, 0.0, 0.0],
                          up=[0.0, 1.0, 0.0], fov=45.0, resolution=res,
                          device=dev)
    tri = rtt.make_shape(
        vertices=[[-1.7, 1.0, 0.0], [1.0, 1.0, 0.0], [-0.5, -1.0, 0.0]],
        indices=[[0, 1, 2]], material_id=0, device=dev)
    light = rtt.make_shape(
        vertices=[[-1.0, -1.0, -7.0], [1.0, -1.0, -7.0], [-1.0, 1.0, -7.0],
                  [1.0, 1.0, -7.0]],
        indices=[[0, 1, 2], [1, 3, 2]], material_id=0, light_id=0,
        device=dev)
    mat = rtt.make_material(diffuse_reflectance=list(diffuse), device=dev)
    return rtt.make_scene(
        cam, [tri, light], [mat],
        area_lights=[rtt.make_area_light(1, [20.0, 20.0, 20.0], device=dev)])


def grad_leaves(scene):
    """(name, tensor) of the leaves the sharding tests differentiate."""
    return [("vertices", scene.shapes[0].vertices),
            ("diffuse", scene.materials[0].diffuse_reflectance.texels),
            ("light intensity", scene.area_lights[0].intensity),
            ("camera position", scene.camera.position)]


def edge_gradient(scene, options, seed, mesh=None):
    """(image, {leaf: gradient}) of render(scene).sum() w.r.t. grad_leaves:
    one process when mesh is None, else render_sharded over the mesh."""
    leaves = grad_leaves(scene)
    for _, x in leaves:
        x.requires_grad_(True)
    try:
        if mesh is None:
            img = rtt.render(scene, options, seed=seed)
        else:
            img = render_sharded(scene, options, seed=seed, mesh=mesh)
        img.sum().backward()
        return img.detach(), {k: x.grad.detach().clone() for k, x in leaves}
    finally:
        for _, x in leaves:
            x.grad = None
            x.requires_grad_(False)


def ad_gradient(scene, options, seed, mesh=None):
    """(image, {leaf: gradient}) of render_image(scene).sum() (AD only)."""
    leaves = grad_leaves(scene)
    for _, x in leaves:
        x.requires_grad_(True)
    try:
        if mesh is None:
            img = rtt.render_image(scene, options, seed=seed)
        else:
            img = render_image_sharded(scene, options, seed=seed, mesh=mesh)
        img.sum().backward()
        return img.detach(), {k: x.grad.detach().clone() for k, x in leaves}
    finally:
        for _, x in leaves:
            x.grad = None
            x.requires_grad_(False)


RENDER_OPTIONS = dict(num_samples=2, max_bounces=1)
# Primary-edge samples that leave the last of three ranks an empty block.
FEW_EDGE_OPTIONS = dict(RENDER_OPTIONS, num_edge_samples=4)
TRAIN_OPTIONS = dict(num_samples=2, max_bounces=1,
                     use_primary_edge_sampling=False,
                     use_secondary_edge_sampling=False)
TRAIN_STEPS = 10
TRAIN_LR = 30.0


def train_losses(mesh):
    """The losses of TRAIN_STEPS steps of make_train_step on the diffuse,
    from a red start toward the gray render (tests/test_sharding.py)."""
    opts = rtt.RenderOptions(**TRAIN_OPTIONS)
    target = rtt.render_image(single_triangle(), opts, seed=0)
    step = make_train_step(opts, mesh=mesh, learning_rate=TRAIN_LR,
                           trainable=lambda p: "diffuse" in p)
    s = single_triangle(diffuse=(0.8, 0.2, 0.2))
    losses = []
    for _ in range(TRAIN_STEPS):
        s, loss = step(s, target, 0)
        losses.append(float(loss))
    return torch.tensor(losses), s.materials[0].diffuse_reflectance.texels


def launches_per_gradient(mesh):
    """(closest hit, any hit) kernel launches of one 16x16, 4 spp gradient
    through render_sharded, with the kernel wrappers counted as on the
    card, at four passes of 256 lanes and primary-edge chunks of 512 pair
    rays (the 256x256 slice's 65,536 and 32,768 scaled down)."""
    trender = importlib.import_module("redner_tpu_torch.render")
    counts = {"closest_hit": 0, "any_hit": 0}
    saved = (trender.SAMPLES_LANE_TARGET, tedge.EDGE_EVAL_CHUNK,
             ic.closest_hit, ic.any_hit)

    def counting(kind, wrapper):
        def run(lay, rb):
            counts[kind] += 1
            return wrapper(lay, rb)
        return run

    trender.SAMPLES_LANE_TARGET, tedge.EDGE_EVAL_CHUNK = 256, 512
    ic.closest_hit = counting("closest_hit", saved[2])
    ic.any_hit = counting("any_hit", saved[3])
    try:
        edge_gradient(single_triangle(), rtt.RenderOptions(
            num_samples=4, max_bounces=1), 0, mesh)
    finally:
        (trender.SAMPLES_LANE_TARGET, tedge.EDGE_EVAL_CHUNK,
         ic.closest_hit, ic.any_hit) = saved
    return counts["closest_hit"], counts["any_hit"]


# The second-order test's scene (tests/test_torch_port_second_order.py).
SECOND_ORDER_RES = (8, 8)
SECOND_ORDER_DIFFUSE = (0.5, 0.4, 0.3)
# Losses of the image: one elementwise, one that couples every pixel (only
# such a loss shows a backward that drops the other ranks' lanes).
SECOND_ORDER_LOSSES = {
    "square": lambda img: torch.sum(img ** 2),
    "coupled": lambda img: torch.sum(img) ** 2 + torch.sum(img ** 2),
}
# (entry point, loss): few_edges is render with FEW_EDGE_OPTIONS.
SECOND_ORDER_CASES = (("render", "square"), ("render", "coupled"),
                      ("render_image", "square"),
                      ("render_image", "coupled"), ("few_edges", "square"))


def second_derivative(entry, loss, mesh=None):
    """h = d/dv sum(d/dv loss(image)) w.r.t. the triangle's vertices (2 spp,
    1 bounce, seed 0) through rtt.render or rtt.render_image, or their
    sharded entry points over mesh -> (h, the (kind, shape) of every
    all-reduce the two passes issued)."""
    scene = single_triangle(SECOND_ORDER_RES, SECOND_ORDER_DIFFUSE)
    v = scene.shapes[0].vertices.requires_grad_(True)
    opts = rtt.RenderOptions(**(FEW_EDGE_OPTIONS if entry == "few_edges"
                                else RENDER_OPTIONS))
    if entry == "render_image":
        fn = rtt.render_image if mesh is None else render_image_sharded
    else:
        fn = rtt.render if mesh is None else render_sharded
    with shardutil.trace_collectives() as issued:
        img = (fn(scene, opts, seed=0) if mesh is None
               else fn(scene, opts, seed=0, mesh=mesh))
        (g,) = torch.autograd.grad(SECOND_ORDER_LOSSES[loss](img), v,
                                   create_graph=True)
        (h,) = torch.autograd.grad(torch.sum(g), v)
    return h, issued


# The firefly clamp's population: 96 lanes, a third with no straddle
# (z = 0), a spread of moderate values and a few spikes above
# FIREFLY_K x the robust mean, where the clamp binds.
FIREFLY_LANES = 96
FIREFLY_K = 3.0


def firefly_inputs():
    """(z, c) of FIREFLY_LANES lanes, made from seed 0 with numpy."""
    rng = np.random.default_rng(0)
    z = rng.exponential(1.0, FIREFLY_LANES)
    z[rng.permutation(FIREFLY_LANES)[:32]] = 0.0
    z[[5, 40, 77]] = [30.0, 55.0, 12.0]
    c = rng.uniform(-1.0, 1.0, FIREFLY_LANES)
    return (torch.tensor(z, dtype=torch.float32),
            torch.tensor(c, dtype=torch.float32))


def firefly_gradient(mesh=None):
    """d sum(firefly_scale(z) * c) / dz on this rank's block of the lanes
    (all of them without a mesh) -> (start, scale, gradient)."""
    z, c = firefly_inputs()
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    lo, hi = shardutil.lane_block(FIREFLY_LANES, rank, world)
    zl = z[lo:hi].clone().requires_grad_(True)
    scale = tedge.firefly_scale(zl, FIREFLY_K, lane_sharding=mesh)
    (gz,) = torch.autograd.grad(torch.sum(scale * c[lo:hi]), zl)
    return lo, scale.detach(), gz


def sharded_results(res=(16, 16), train=True):
    """What one rank computes for the sharding tests: render_image_sharded,
    render_sharded's image and gradients (also with FEW_EDGE_OPTIONS), the
    AD gradient of render_image_sharded, the second derivatives of
    SECOND_ORDER_CASES with the collectives they issued, the firefly
    clamp's gradient and, with train, the train step's losses and the
    launches of one gradient."""
    # One intra-op thread: the ranks' sums then run in a fixed order.
    torch.set_num_threads(1)
    mesh = make_mesh("cpu")
    opts = rtt.RenderOptions(**RENDER_OPTIONS)
    scene = single_triangle(res)
    out = {"rank": mesh.rank, "world": mesh.world}
    with torch.no_grad():
        out["image"] = render_image_sharded(scene, opts, seed=0, mesh=mesh)
    out["edge_image"], out["edge_grads"] = edge_gradient(scene, opts, 1, mesh)
    out["ad_image"], out["ad_grads"] = ad_gradient(scene, opts, 1, mesh)
    _, out["few_edge_grads"] = edge_gradient(
        scene, rtt.RenderOptions(**FEW_EDGE_OPTIONS), 1, mesh)
    out["second_order"] = {case: second_derivative(*case, mesh)
                           for case in SECOND_ORDER_CASES}
    out["firefly"] = firefly_gradient(mesh)
    if train:
        out["losses"], out["trained_diffuse"] = train_losses(mesh)
        out["launches"] = launches_per_gradient(mesh)
    return out



def with_grad_leaves(scene):
    """Mark and return the leaves the graph-body tests differentiate: the
    first material's diffuse, the first light's intensity, every shape's
    vertices and the camera position."""
    leaves = ([scene.materials[0].diffuse_reflectance.texels,
               scene.area_lights[0].intensity]
              + [s.vertices for s in scene.shapes] + [scene.camera.position])
    for x in leaves:
        x.requires_grad_(True)
    return leaves


def program_bodies(scene, options_kw, seed, ct, sharding=None):
    """What the graphs of render (kind "render") and of render_image under
    autograd ("render_image_grad") capture, run eagerly: each program's
    forward body's image and its backward body's gradients of <image, ct>
    w.r.t. the with_grad_leaves leaves, in that order -> {kind: (image,
    [gradients])}.  Without a sharding, the process group's mesh when one
    is initialised."""
    from redner_tpu_torch.render_grad import (_make_program,
                                              _render_image_program)
    from redner_tpu_torch.scene import scene_tensors

    torch.set_num_threads(1)
    if sharding is None and torch.distributed.is_initialized():
        sharding = make_mesh("cpu")
    leaves = with_grad_leaves(scene)
    at = {id(t): i for i, t in enumerate(scene_tensors(scene))}
    opts = rtt.RenderOptions(**options_kw)
    seed = torch.tensor(seed, dtype=torch.int64)
    out = {}
    for kind, make in (
            ("render", _make_program(opts, True, None, sharding)),
            ("render_image_grad", _render_image_program(opts, None,
                                                        sharding))):
        prog = make(scene)
        img = prog._forward_body(scene, seed)
        with torch.no_grad():  # as autograd runs a first-order backward
            grads = prog._backward_body(scene, seed, ct)
        out[kind] = (img, [grads[at[id(x)]] for x in leaves])
    return out
