"""`render`: the differentiable entry point with edge-sampled visibility
gradients (port of redner_tpu/render_grad.py).

A torch.autograd.Function whose forward is render_image and whose backward
sums three gradients of one re-render, taken by torch.autograd:

  1. the continuous gradients, by autograd through the re-render;
  2. the secondary-edge surrogate, fused into the re-render's bounce loop
     (render._render_image_impl with secondary_d_radiance), so each camera
     path is traced once (src/pathtracer.cpp:431-707);
  3. the primary-edge surrogate (edge.primary_edge_gradients).

The backward re-renders with the forward's RNG stream (correlated replay,
pyredner/render_pytorch.py:10-29); set_use_correlated_random_number(False)
switches to seed + 1.

RenderOptions.remat checkpoints each pass of the re-render
(render._render_image_impl): the backward then holds one pass's autograd
residuals at a time.  RenderOptions.isect_replay_max_mb is accepted and
changes nothing.  The JAX version keeps the forward's ray-query results
for the re-render; on the card that saved under 1% of a gradient's device
time and made the gradient no faster (PERF.md), so the re-render here runs
its ray queries again and gives the same gradient.

pixel_sharding (parallel.sharding.pixel_sharding) runs the forward, the
re-render with its secondary edges and the primary edges on this rank's
lanes; the backward then sums the leaves' gradients over the ranks in one
all-reduce, so every rank holds the one-process gradient.

`render` on a card scene replays cached CUDA graphs (graphs.py; the JAX
package's jit cache of `render`, :186-205): the first call for a
configuration runs the forward eagerly and measures it, the second
captures it, and so for the backward; later calls replay them.  Under a pixel sharding that holds for
an NCCL group (its collectives are captured with the rest); a gloo group
runs make_render's eager function, chosen from the group's backend before
anything is captured (graphs.replays).  `make_render(options)` is the
eager function (JAX `make_render`, :46): every call runs from Python on
any device, which is what launch counting and tracing need; a CPU scene
runs it too.

Second derivatives (torch.autograd.grad(..., create_graph=True)): JAX
differentiates render's custom_vjp bwd through the residual scene and the
cotangent, with only its stop_gradients, and the forward's image as
plain code.  The port does the same: a backward entered with grad
enabled keeps the saved tensors and ct_img (_scene_grads) and passes its
gradients through _Recorded, which notes on the render's ctx each
autograd pass that differentiates them; in such a pass the render's
backward (the outer pass through the image) is the continuous one at the
forward's options and seed (_backward).  Any other backward of the same
render, such as a first-order loss.backward() after the recording one,
stays edge-sampled.  A single pass that differentiates a recorded
gradient and the image's own loss together gets the continuous backward
for both.  On a card these backwards run eagerly.  Under a pixel
sharding over a process group they raise NotImplementedError (the
all-reduce of the gradients is not differentiable).

`graphed_render_image` is `render_image` under autograd on a card (JAX:
jax.grad of `_render_image_jitted`): the same two graphs, its backward
the body above with both edge samplers off, at the forward's own options
and seed, which is autograd through render_image.
"""

from __future__ import annotations

import torch

from redner_tpu_torch import graphs
from redner_tpu_torch.core.shardutil import (all_reduce_grads,
                                             no_second_order, sharded)
from redner_tpu_torch.edge import primary_edge_gradients
from redner_tpu_torch.render import (RenderOptions, _render_image_impl,
                                     graph_forward, render_sample)
from redner_tpu_torch.sampler import _as_u32
from redner_tpu_torch.scene import (flatten_scene, scene_tensors,
                                    scene_with_tensors)

_use_correlated = True


def set_use_correlated_random_number(v: bool):
    """Reference global (pyredner/render_pytorch.py:10-29)."""
    global _use_correlated
    _use_correlated = bool(v)


def get_use_correlated_random_number() -> bool:
    return _use_correlated


def default_num_edge_samples(options: RenderOptions, n_pix: int) -> int:
    """The primary-edge budget of one backward: a quarter of the backward's
    lane count, at least 16,384 and at most all of it."""
    full = n_pix * options.num_samples_backward
    return options.num_edge_samples or min(full, max(full // 4, 16384))


def _scene_grads(scene, tensors, needs, options, seed, correlated, engine,
                 sharding, ct_img):
    """The edge-sampled backward: the gradient of <render(scene), ct_img>
    w.r.t. each tensors[i] (scene_tensors order) with needs[i], None for
    the others and where a tensor is unused.  seed is the forward's int64
    seed tensor; the decorrelated seed + 1 wraps on the device."""
    seed_b = seed if correlated else (seed + 1) & 0xFFFFFFFF
    options_b = options
    if options.num_samples_backward != options.num_samples:
        options_b = options._copy_with(
            num_samples=options.num_samples_backward)
    roff = options.channel_info.radiance_dimension
    use_secondary = options.use_secondary_edge_sampling and roff >= 0
    # Under create_graph (grad enabled on entry, as autograd runs a
    # backward that it records) the re-render is differentiated as JAX
    # differentiates its bwd: through the saved tensors and ct_img, with
    # only the stop_gradients of the reference (the secondary radiance
    # adjoint, detached in _render_image_impl; the primary surrogate's
    # weights, in edge.primary_edge_gradients).  A view per leaf gives
    # each scene field its own gradient, as the detached copies do.
    create_graph = torch.is_grad_enabled()
    if create_graph:
        if sharded(sharding):
            no_second_order("the gradients' all-reduce")
        leaves = [x.view_as(x) if n else x.detach()
                  for x, n in zip(tensors, needs)]
    else:
        ct_img = ct_img.detach()
        leaves = [x.detach().requires_grad_(n)
                  for x, n in zip(tensors, needs)]
    top, left, bottom, right = scene.camera.viewport_or_full
    num_edge_samples = default_num_edge_samples(
        options, (right - left) * (bottom - top))
    with torch.enable_grad():
        s = scene_with_tensors(scene, leaves)
        if use_secondary:
            img, surr = _render_image_impl(
                s, options_b, seed_b, engine,
                secondary_d_radiance=ct_img[..., roff:roff + 3],
                pixel_sharding=sharding)
        else:
            img = _render_image_impl(s, options_b, seed_b, engine,
                                     pixel_sharding=sharding)
            surr = torch.zeros((), dtype=ct_img.dtype, device=ct_img.device)
        if options.use_primary_edge_sampling:
            surr = surr + primary_edge_gradients(
                s, flatten_scene, render_sample, options_b, seed_b,
                ct_img, num_edge_samples, engine=engine,
                lane_sharding=sharding)
        # <img, ct_img> + surrogate: what JAX's vjp((ct_img, 1)) gives.
        # Under a sharding each term is this rank's part of the sum.
        total = torch.sum(img * ct_img) + surr
        wrt = [x for x, n in zip(leaves, needs) if n]
        grads = torch.autograd.grad(total, wrt, allow_unused=True,
                                    create_graph=create_graph)
    if sharding is not None:
        # Zeros for unused leaves: every rank then reduces the same
        # shapes, whichever leaves its own lanes reach.
        grads = all_reduce_grads(
            [torch.zeros_like(x) if g is None else g
             for x, g in zip(wrt, grads)], sharding)
    grads = iter(grads)
    return tuple(next(grads) if n else None for n in needs)


def _continuous(options):
    """options with both edge samplers off and the backward at the
    forward's sample count: autograd through render_image."""
    return options._copy_with(
        use_primary_edge_sampling=False, use_secondary_edge_sampling=False,
        num_samples_backward=options.num_samples)


def _graph_task():
    """The id of the autograd pass running this backward."""
    return torch._C._current_graph_task_id()


class _Recorded(torch.autograd.Function):
    """The identity on the gradients a render's backward recorded
    (create_graph): a pass that differentiates them notes its id on the
    render's ctx (it runs before the render's own backward in that pass,
    which lies below it through ct_img)."""

    @staticmethod
    def forward(ctx, render_ctx, *grads):
        ctx.render_ctx = render_ctx
        return tuple(g.view_as(g) for g in grads)

    @staticmethod
    def backward(ctx, *cts):
        ctx.render_ctx.outer_passes.add(_graph_task())
        return (None, *cts)


def _differentiates_recorded(ctx):
    """Whether this backward of a render belongs to a pass that
    differentiates a gradient the render recorded."""
    return _graph_task() in ctx.outer_passes


def _backward(ctx, scene, tensors, seed, ct_img, options, correlated,
              engine, sharding):
    """The gradients of one render's backward.  In a pass that
    differentiates a gradient this render recorded (create_graph), the
    continuous one at the forward's options and seed: JAX differentiates
    a custom_vjp's forward as plain code when it differentiates its
    backward (reverse over reverse), so the image that the recorded
    gradient depends on carries no edge terms.  A backward that records
    passes its gradients through _Recorded."""
    if _differentiates_recorded(ctx):
        options, correlated = _continuous(options), True
    grads = _scene_grads(scene, tensors, ctx.needs_input_grad[-len(tensors):],
                         options, seed, correlated, engine, sharding, ct_img)
    if not torch.is_grad_enabled():
        return grads
    kept = [g for g in grads if g is not None]
    marked = iter(_Recorded.apply(ctx, *kept))
    return tuple(None if g is None else next(marked) for g in grads)


class _RenderFunction(torch.autograd.Function):
    """The eager render: forward(scene, options, seed, correlated, engine,
    pixel_sharding, *tensors).  The tensors are scene_tensors(scene),
    passed explicitly so autograd sees them; the scene supplies the
    structure."""

    @staticmethod
    def forward(ctx, scene, options, seed, correlated, engine,
                pixel_sharding, *tensors):
        ctx.scene = scene
        ctx.options = options
        ctx.correlated = correlated
        ctx.engine = engine
        ctx.pixel_sharding = pixel_sharding
        ctx.outer_passes = set()
        ctx.save_for_backward(seed, *tensors)
        return _render_image_impl(scene_with_tensors(scene, tensors), options,
                                  seed, engine, pixel_sharding=pixel_sharding)

    @staticmethod
    def backward(ctx, ct_img):
        # The correlated flag is the one snapshotted when render was called.
        seed, *tensors = ctx.saved_tensors
        return (None,) * 6 + _backward(
            ctx, ctx.scene, tensors, seed, ct_img, ctx.options,
            ctx.correlated, ctx.engine, ctx.pixel_sharding)


class _GraphedRender(torch.autograd.Function):
    """The compiled render: forward(program, spec, seed, *tensors) replays
    the program's forward graph, backward its backward graph.  spec:
    (backward options, correlated, engine, pixel_sharding) of the
    program's backward body, which a backward that records, or belongs to
    a pass that differentiates a recorded gradient, runs eagerly on the
    saved tensors (graphs.EAGER["create_graph"]): a graph's outputs carry
    no history."""

    @staticmethod
    def forward(ctx, program, spec, seed, *tensors):
        ctx.program = program
        ctx.spec = spec
        ctx.outer_passes = set()
        ctx.save_for_backward(seed, *tensors)
        return program.forward(tensors, seed)

    @staticmethod
    def backward(ctx, ct_img):
        seed, *tensors = ctx.saved_tensors
        if not (torch.is_grad_enabled() or _differentiates_recorded(ctx)):
            return (None,) * 3 + ctx.program.backward(tensors, seed, ct_img)
        graphs.EAGER["create_graph"] += 1
        scene = scene_with_tensors(ctx.program.scene, tensors)
        return (None,) * 3 + ctx.program.run_eagerly(
            "create_graph", lambda: _backward(ctx, scene, tensors, seed,
                                              ct_img, *ctx.spec))


def _scene_device(scene):
    return scene.shapes[0].vertices.device


def make_render(options: RenderOptions, pixel_sharding=None,
                correlated=None, engine=None):
    """The eager edge-sampled render for a static RenderOptions (JAX
    make_render, redner_tpu/render_grad.py:46): fn(scene, seed=0) ->
    image, differentiable like `render`, run from Python on every call
    (every kernel launched by its wrapper and counted), on any device.

    correlated: the correlated-replay flag this function is built for
    (default: the current global), so toggling the global between the
    forward and the backward changes nothing.  engine, pixel_sharding: as
    for `render`."""
    correlated = _use_correlated if correlated is None else bool(correlated)

    def fn(scene, seed=0):
        return _RenderFunction.apply(
            scene, options, _as_u32(seed, _scene_device(scene)), correlated,
            engine, pixel_sharding, *scene_tensors(scene))

    return fn


def _make_program(options, correlated, engine, sharding=None,
                  backward_options=None):
    """make(scene) -> the Program of render at options (the backward at
    backward_options, default options) over `sharding`."""
    backward_options = backward_options or options

    def make(scene):
        needs = [t.requires_grad for t in scene_tensors(scene)]

        def backward(s, seed, ct):
            return _scene_grads(s, scene_tensors(s), needs, backward_options,
                                seed, correlated, engine, sharding, ct)

        return graphs.Program(
            scene, graph_forward(options, engine, sharding), backward)

    return make


def render(scene, options: RenderOptions, seed=0, engine=None,
           pixel_sharding=None):
    """Differentiable render with edge-sampled visibility gradients: returns
    render_image(scene, options, seed); its backward gives every float
    tensor of the scene (scene_leaves) the reference's scene gradient.

    On a card scene the call replays the cached CUDA graphs of its
    configuration (graphs.py), capturing each at its second call (the
    first runs eagerly); the image and the gradients are fresh
    tensors.  So does a pixel sharding over an NCCL group.  A CPU scene, a
    gloo group and graphs.disable() run make_render's eager function.

    seed: an int (wrapped to 32 bits) or an integer tensor, taken to the
    scene's device.  engine: None = the CUDA kernels on a card scene
    (plain versions on a CPU scene); "plain" (or its aliases "bruteforce"
    and "cluster") forces the plain ray queries.  pixel_sharding: see
    parallel.sharding.render_sharded."""
    dev = _scene_device(scene)
    if not graphs.replays(dev, pixel_sharding):
        return make_render(options, pixel_sharding, _use_correlated,
                           engine)(scene, seed)
    prog = graphs.program(
        "render", scene, options, _use_correlated, engine,
        _make_program(options, _use_correlated, engine, pixel_sharding),
        pixel_sharding)
    return _GraphedRender.apply(
        prog, (options, _use_correlated, engine, pixel_sharding),
        _as_u32(seed, dev), *scene_tensors(scene))


def _render_image_program(options, engine, sharding=None):
    """make(scene) -> the Program of render_image under autograd: render's
    program with the backward at the forward's own options and seed
    (correlated) and both edge samplers off, which is autograd through
    render_image (jax.grad of _render_image_jitted)."""
    return _make_program(options, True, engine, sharding,
                         _continuous(options))


def graphed_render_image(scene, options: RenderOptions, seed, engine,
                         pixel_sharding):
    """render_image under autograd, replayed from graphs (render.render_image
    calls it on a card): the forward graph renders the image; the backward
    graph re-renders under autograd and takes autograd.grad, the leaves'
    gradients summed over the ranks under a sharding.  seed: the int64
    device seed."""
    prog = graphs.program(
        "render_image_grad", scene, options, None, engine,
        _render_image_program(options, engine, pixel_sharding),
        pixel_sharding)
    return _GraphedRender.apply(
        prog, (_continuous(options), True, engine, pixel_sharding), seed,
        *scene_tensors(scene))
