"""redner_tpu_torch.frontend (the pyredner-style torch front end over the
port) against redner_torch (the same front end over JAX) on the CPU.

The scene is tests/test_redner_torch.py's triangle + quad light at 16x16,
2 spp, 1 bounce, rendered by both front ends at a matched seed: images at
rtol 1e-4, gradients w.r.t. the vertices, the diffuse reflectance, the
camera position and the light intensity at rtol 1e-3 (atol 1e-5 x max),
from one module-scoped redner_torch render + backward (one JAX compile of
the edge-sampled gradient).  Then the non-fixture patterns of
tests/test_redner_torch.py on the port, the load-time weld that
redner_torch drops, and every front-end leaf's gradient against the
functional port's on the same scene (bit for bit, one CPU thread).
"""

import numpy as np
import pytest
import torch

import redner_tpu_torch as rtt
import redner_tpu_torch.frontend as pyredner
from redner_tpu_torch.edge import build_edges
from redner_tpu_torch.scene import scene_leaves
from tests.torch_port_util import (cpu_default_device,  # noqa: F401
                                   one_thread, two_torch_threads)

SEED = 3
RES = (16, 16)
TRI = [[-1.7, 1.0, 0.0], [1.0, 1.0, 0.0], [-0.5, -1.0, 0.0]]
DIFFUSE = [0.5, 0.4, 0.3]
LEAVES = ("vertices", "diffuse", "camera_position", "light_intensity")


def _weight():
    return np.random.default_rng(1).uniform(0.5, 1.5, RES + (3,)).astype(
        np.float32)


def _scene(pr, res=RES, requires_grad=False):
    """tests/test_redner_torch.py:_torch_scene through front end `pr`;
    returns the scene and its four leaves (LEAVES order)."""
    cam = pr.Camera(position=[0.0, 0.0, -5.0], look_at=[0.0, 0.0, 0.0],
                    up=[0.0, 1.0, 0.0], fov=[45.0], resolution=res)
    verts = torch.tensor(TRI, requires_grad=requires_grad)
    diffuse = torch.tensor(DIFFUSE, requires_grad=requires_grad)
    obj = pr.Object(vertices=verts, indices=[[0, 1, 2]],
                    material=pr.Material(diffuse_reflectance=diffuse))
    light = pr.generate_quad_light(position=[0.0, 0.0, -7.0],
                                   look_at=[0.0, 0.0, 0.0], size=[2.0, 2.0],
                                   intensity=[20.0, 20.0, 20.0])
    scene = pr.Scene(camera=cam, objects=[obj, light])
    leaves = [verts, diffuse, scene.camera.position,
              scene.area_lights[0].intensity]
    for x in leaves:
        x.requires_grad_(requires_grad)
    return scene, leaves


def _grads(pr, scene, leaves, seed=SEED):
    img = pr.render(scene, num_samples=2, max_bounces=1, seed=seed)
    torch.sum(img * torch.as_tensor(_weight())).backward()
    return img.detach().numpy(), [x.grad.detach().clone().numpy()
                                  for x in leaves]


@pytest.fixture(scope="module")
def reference():
    """redner_torch's image and gradients (JAX's edge-sampled backward)."""
    import redner_torch

    scene, leaves = _scene(redner_torch, requires_grad=True)
    return _grads(redner_torch, scene, leaves)


@pytest.fixture(scope="module")
def port():
    rtt.set_device("cpu")
    try:
        scene, leaves = _scene(pyredner, requires_grad=True)
        return _grads(pyredner, scene, leaves)
    finally:
        rtt.set_device(None)


def test_forward_matches_redner_torch(reference, port):
    np.testing.assert_allclose(port[0], reference[0], rtol=1e-4, atol=1e-6)
    assert port[0].sum() > 0


@pytest.mark.parametrize("i", range(len(LEAVES)), ids=LEAVES)
def test_gradients_match_redner_torch(reference, port, i):
    g, r = port[1][i], reference[1][i]
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-5 * np.abs(r).max())
    assert np.abs(r).max() > 0


def test_two_forwards_then_backwards(cpu_default_device):
    """Two renders before one backward: each keeps its own graph."""
    scene, (verts, *_) = _scene(pyredner)
    verts.requires_grad_(True)
    img_a = pyredner.render(scene, num_samples=2, max_bounces=1, seed=1)
    img_b = pyredner.render(scene, num_samples=2, max_bounces=1, seed=1)
    (img_a.sum() + img_b.sum()).backward()
    g_both = verts.grad.clone()
    verts.grad = None
    pyredner.render(scene, num_samples=2, max_bounces=1, seed=1).sum() \
        .backward()
    np.testing.assert_allclose(g_both.numpy(), 2 * verts.grad.numpy(),
                               rtol=1e-4, atol=1e-6)


def test_camera_gradients_flow(cpu_default_device):
    scene, _ = _scene(pyredner)
    scene.camera.position.requires_grad_(True)
    pyredner.render(scene, num_samples=2, max_bounces=1, seed=1).sum() \
        .backward()
    g = scene.camera.position.grad
    assert g is not None and bool(torch.isfinite(g).all())
    assert float(g.abs().sum()) > 0


def test_deferred_albedo_and_g_buffer(cpu_default_device):
    """The deferred, albedo and G-buffer renders equal the functional
    port's on the built scene, and the deferred gradient reaches the
    diffuse leaf."""
    scene, (_, diffuse, *_) = _scene(pyredner)
    diffuse.requires_grad_(True)
    lights = [pyredner.PointLight(position=[0.0, 0.0, -4.0],
                                  intensity=[10.0, 10.0, 10.0]),
              pyredner.AmbientLight(intensity=[0.1, 0.1, 0.1])]
    img = pyredner.render_deferred(scene, lights, aa_samples=1, seed=0)
    assert img.shape == RES + (3,)
    assert torch.equal(img, rtt.render_deferred(scene._build(), lights,
                                                aa_samples=1, seed=0))
    img.sum().backward()
    assert diffuse.grad is not None and bool(torch.isfinite(diffuse.grad)
                                             .all())
    assert float(diffuse.grad.abs().sum()) > 0
    alb = pyredner.render_albedo(scene, num_samples=2, seed=0)
    assert bool(torch.isfinite(alb).all())
    chans = [pyredner.channels.depth, pyredner.channels.shading_normal]
    g = pyredner.render_g_buffer(scene, chans, num_samples=1, seed=0)
    assert g.shape == RES + (4,) and bool(torch.isfinite(g).all())
    assert torch.equal(g, rtt.render_g_buffer(scene._build(), chans,
                                              num_samples=1, seed=0))


def test_explicit_constructor_wires_area_lights(cpu_default_device):
    """Scene(camera, shapes, materials, area_lights): emission is defined
    by AreaLight.shape_id alone, so the front end wires the port's
    per-shape light ids itself."""
    cam = pyredner.Camera(position=[0.0, 0.0, -5.0], look_at=[0.0, 0.0, 0.0],
                          up=[0.0, 1.0, 0.0], fov=[45.0], resolution=(8, 8))
    tri = pyredner.Shape(vertices=TRI, indices=[[0, 1, 2]], material_id=0)
    lshape = pyredner.Shape(
        vertices=[[-1.0, -1.0, -7.0], [1.0, -1.0, -7.0], [-1.0, 1.0, -7.0],
                  [1.0, 1.0, -7.0]],
        indices=[[0, 1, 2], [1, 3, 2]], material_id=1)
    mats = [pyredner.Material(diffuse_reflectance=DIFFUSE),
            pyredner.Material(diffuse_reflectance=[0.0, 0.0, 0.0])]
    lights = [pyredner.AreaLight(shape_id=1, intensity=[20.0, 20.0, 20.0])]
    scene = pyredner.Scene(camera=cam, shapes=[tri, lshape], materials=mats,
                           area_lights=lights)
    assert [s.light_id for s in scene._build().shapes] == [-1, 0]
    img = pyredner.render_pathtracing(scene, num_samples=2, max_bounces=1,
                                      seed=0)
    assert bool(torch.isfinite(img).all())
    assert float(img.sum()) > 0  # the light emits


def test_sh_and_geometry_image_utilities(cpu_default_device):
    theta = torch.tensor([0.3, 1.2, 2.5])
    phi = torch.tensor([0.1, 2.0, 4.0])
    # Y_0^0 is the constant 1 / (2 sqrt(pi)).
    np.testing.assert_allclose(pyredner.SH(0, 0, theta, phi).numpy(),
                               np.full(3, 0.28209479), rtol=1e-5)
    # Y_1^0 = sqrt(3 / (4 pi)) cos(theta).
    np.testing.assert_allclose(pyredner.SH(1, 0, theta, phi).numpy(),
                               0.48860251 * np.cos(theta.numpy()), rtol=1e-5)
    img = pyredner.SH_reconstruct(torch.rand(9, 3), (8, 16))
    assert img.shape == (16, 8, 3) and bool(torch.isfinite(img).all())
    # (2 size + 1)^2 vertices
    v, i, uvs = pyredner.generate_geometry_image(2)
    assert v.shape == (25, 3) and i.shape == (32, 3) and uvs.shape == (25, 2)
    assert i.dtype == torch.int32


def test_global_switches():
    """set_print_timing and set_use_correlated_random_number, restored
    (correlated replay is a process-wide default other tests rely on)."""
    old_timing = pyredner.get_print_timing()
    old_corr = pyredner.get_use_correlated_random_number()
    try:
        pyredner.set_print_timing(True)
        pyredner.set_use_correlated_random_number(False)
        assert pyredner.get_print_timing() is True
        assert rtt.get_print_timing() is True
        assert pyredner.get_use_correlated_random_number() is False
        assert rtt.get_use_correlated_random_number() is False
    finally:
        pyredner.set_print_timing(old_timing)
        pyredner.set_use_correlated_random_number(old_corr)


def test_print_timing_reports_each_render(cpu_default_device, capsys):
    scene, _ = _scene(pyredner, res=(4, 4))
    pyredner.set_print_timing(True)
    try:
        pyredner.render(scene, num_samples=1, max_bounces=1, seed=0)
    finally:
        pyredner.set_print_timing(False)
    out = capsys.readouterr().out
    assert "scene construction:" in out and "forward pass:" in out


def test_batch_render_scene_list(cpu_default_device):
    """A list of scenes renders to a stacked (B, H, W, C) tensor, scene i
    with seed[i] or seed + i, and gradients reach every scene's leaves."""
    s0, (v0, *_) = _scene(pyredner, requires_grad=True)
    s1, (v1, *_) = _scene(pyredner, requires_grad=True)
    with torch.no_grad():
        v1 += torch.tensor([[0.1, 0.0, 0.0]] * 3)
    imgs = pyredner.render_pathtracing([s0, s1], num_samples=2,
                                       max_bounces=1, seed=[3, 4])
    assert imgs.shape == (2,) + RES + (3,)
    solo = pyredner.render_pathtracing(s1, num_samples=2, max_bounces=1,
                                       seed=4)
    assert torch.equal(imgs[1], solo)
    default = pyredner.render_pathtracing([s0, s1], num_samples=2,
                                          max_bounces=1, seed=3)
    assert torch.equal(default[1], solo)  # seed + i
    imgs.sum().backward()
    for v in (v0, v1):
        assert v.grad is not None and bool(torch.isfinite(v.grad).all())
        assert float(v.grad.abs().sum()) > 0.0
    lights = [pyredner.AmbientLight(intensity=[0.2, 0.2, 0.2])]
    d = pyredner.render_deferred([s0, s1], lights, aa_samples=1, seed=0)
    assert d.shape == (2,) + RES + (3,) and bool(torch.isfinite(d).all())
    per = pyredner.render_deferred(
        [s0, s1], [lights, [pyredner.AmbientLight([0.4, 0.4, 0.4])]],
        aa_samples=1, seed=0)
    assert torch.equal(per[0], d[0])
    assert torch.allclose(per[1], 2 * d[1])
    with pytest.raises(ValueError):
        pyredner.render_pathtracing([s0, s1], num_samples=1, seed=[1, 2, 3])


def test_optimization_recovers_diffuse(cpu_default_device):
    """Adam on the front end's tensors recovers a diffuse albedo from a
    target render: the inverse-rendering loop of tutorial 01."""
    target_scene, _ = _scene(pyredner)
    target = pyredner.render(target_scene, num_samples=4, max_bounces=1,
                             seed=5).detach()
    scene, _ = _scene(pyredner)
    guess = torch.tensor([0.1, 0.8, 0.6], requires_grad=True)
    scene.materials[0].diffuse_reflectance.texels = guess
    opt = torch.optim.Adam([guess], lr=0.05)
    for _ in range(40):
        opt.zero_grad()
        img = pyredner.render(scene, num_samples=4, max_bounces=1, seed=5)
        ((img - target) ** 2).sum().backward()
        opt.step()
        with torch.no_grad():
            guess.clamp_(0.0, 1.0)
    np.testing.assert_allclose(guess.detach().numpy(), DIFFUSE, atol=0.05)


def _functional(scene, leaves_of):
    """The same scene through rtt.make_*: (scene, its tensors in the front
    end's leaf order)."""
    cam = rtt.make_camera(position=[0.0, 0.0, -5.0], look_at=[0.0, 0.0, 0.0],
                          up=[0.0, 1.0, 0.0], fov=[45.0],
                          resolution=scene.camera.resolution, device="cpu")
    shapes = [rtt.make_shape(vertices=s.vertices.detach().clone(),
                             indices=s.indices, material_id=s.material_id,
                             light_id=lid, device="cpu")
              for s, lid in zip(scene.shapes, (-1, 0))]
    mats = [rtt.make_material(
        diffuse_reflectance=m.diffuse_reflectance.texels.detach().clone(),
        device="cpu") for m in scene.materials]
    lights = [rtt.make_area_light(1, scene.area_lights[0].intensity.detach()
                                  .clone(), device="cpu")]
    fscene = rtt.make_scene(cam, shapes, mats, area_lights=lights)
    return fscene, leaves_of(fscene)


def test_changing_topology_loop(cpu_default_device, one_thread):
    """A loop over changing topology (1 or 2 triangles, varying indices)
    renders and differentiates each step as the functional port does on
    the same scene; nothing is cached across steps."""
    base = [[-1.7, 1.0, 0.0], [1.0, 1.0, 0.0], [-0.5, -1.0, 0.0],
            [0.8, -0.9, 0.0]]
    topologies = ([[0, 1, 2]], [[0, 1, 3]], [[0, 1, 2], [0, 2, 3]])
    for k in range(6):
        cam = pyredner.Camera(position=[0.0, 0.0, -5.0],
                              look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                              fov=[45.0], resolution=(8, 8))
        verts = torch.tensor(base, requires_grad=True)
        obj = pyredner.Object(vertices=verts, indices=topologies[k % 3],
                              material=pyredner.Material(
                                  diffuse_reflectance=DIFFUSE))
        light = pyredner.generate_quad_light(
            position=[0.0, 0.0, -7.0], look_at=[0.0, 0.0, 0.0],
            size=[2.0, 2.0], intensity=[20.0, 20.0, 20.0])
        scene = pyredner.Scene(camera=cam, objects=[obj, light])
        img = pyredner.render(scene, num_samples=1, max_bounces=1, seed=k)
        img.sum().backward()
        fscene, (fverts,) = _functional(
            scene, lambda s: [s.shapes[0].vertices])
        fverts.requires_grad_(True)
        fimg = rtt.render(fscene, rtt.RenderOptions(num_samples=1),
                          seed=k)
        fimg.sum().backward()
        assert torch.equal(img, fimg)
        assert torch.equal(verts.grad, fverts.grad)
        assert bool(torch.isfinite(verts.grad).all())


def test_every_leaf_gradient_equals_functional_port(cpu_default_device,
                                                    one_thread):
    """Each front-end leaf (vertices, diffuse, camera vectors, fov, light
    intensity) gets the functional port's gradient on the same
    scene, bit for bit: the front end adds no op but the scene build."""
    scene, _ = _scene(pyredner)
    cam = scene.camera
    front = [scene.shapes[0].vertices, scene.shapes[1].vertices,
             scene.materials[0].diffuse_reflectance.texels, cam.position,
             cam.look_at, cam.up, cam.fov,
             scene.area_lights[0].intensity]
    for x in front:
        x.requires_grad_(True)
    w = torch.as_tensor(_weight())
    img = pyredner.render(scene, num_samples=2, max_bounces=1, seed=SEED)
    torch.sum(img * w).backward()

    fov = torch.tensor([45.0], requires_grad=True)
    fscene, fleaves = _functional(scene, lambda s: [
        s.shapes[0].vertices, s.shapes[1].vertices,
        s.materials[0].diffuse_reflectance.texels, s.camera.position,
        s.camera.look_at, s.camera.up,
        s.area_lights[0].intensity])
    fscene.camera = rtt.make_camera(
        position=fscene.camera.position, look_at=fscene.camera.look_at,
        up=fscene.camera.up, fov=fov, resolution=RES, device="cpu")
    fleaves.insert(6, fov)
    for x in fleaves:
        x.requires_grad_(True)
    fimg = rtt.render(fscene, rtt.RenderOptions(num_samples=2,
                                                max_bounces=1), seed=SEED)
    torch.sum(fimg * w).backward()
    assert torch.equal(img, fimg)
    for a, b in zip(front, fleaves):
        assert a.grad is not None and torch.equal(a.grad, b.grad)
    assert float(cam.fov.grad.abs()) > 0


def _write_split_obj(path, v, f):
    """One OBJ vertex per face corner, printed at %.6g (a split-vertex
    export, as a DCC tool writes one)."""
    with open(path, "w") as out:
        for p in v[f].reshape(-1, 3):
            out.write("v %.6g %.6g %.6g\n" % tuple(p))
        for k in range(f.shape[0]):
            out.write(f"f {3 * k + 1} {3 * k + 2} {3 * k + 3}\n")


def test_loaded_obj_keeps_the_weld(cpu_default_device, one_thread, tmp_path):
    """A split-vertex OBJ loaded through the front end has the edge table
    and the gradient of rtt.load_obj + rtt.scene_from_objects: the weld
    that redner_torch drops (its _convert passes no weld_ids)."""
    v, f, _, _ = rtt.generate_sphere(6, 10, device="cpu")
    path = str(tmp_path / "sphere.obj")
    _write_split_obj(path, v.numpy(), f.numpy())

    objs = pyredner.load_obj(path, return_objects=True)
    assert objs[0].weld_ids is not None
    light = pyredner.generate_quad_light(position=[0.0, 0.0, -7.0],
                                         look_at=[0.0, 0.0, 0.0],
                                         size=[2.0, 2.0],
                                         intensity=[20.0, 20.0, 20.0])
    cam = pyredner.Camera(position=[0.0, 0.0, -5.0], look_at=[0.0, 0.0, 0.0],
                          up=[0.0, 1.0, 0.0], fov=[45.0], resolution=(8, 8))
    scene = pyredner.Scene(camera=cam, objects=objs + [light])

    robjs = rtt.load_obj(path, return_objects=True, device="cpu")
    rlight = rtt.generate_quad_light([0.0, 0.0, -7.0], [0.0, 0.0, 0.0],
                                     [2.0, 2.0], [20.0, 20.0, 20.0],
                                     device="cpu")
    rcam = rtt.make_camera(position=[0.0, 0.0, -5.0], look_at=[0.0, 0.0, 0.0],
                           up=[0.0, 1.0, 0.0], fov=[45.0], resolution=(8, 8),
                           device="cpu")
    rscene = rtt.scene_from_objects(rcam, robjs + [rlight])

    e = build_edges(rtt.flatten_scene(scene._build()))
    r = build_edges(rtt.flatten_scene(rscene))
    for name in ("v0", "v1", "f0", "f1", "valid"):
        assert torch.equal(getattr(e, name), getattr(r, name)), name
    nosplit = rtt.make_scene(
        rcam, [rtt.make_shape(objs[0].vertices, objs[0].indices,
                              device="cpu")],
        [rtt.make_material(device="cpu")])
    unwelded = build_edges(rtt.flatten_scene(nosplit))  # no weld_ids
    boundary = lambda x: int((x.valid & (x.f1 < 0)).sum())  # noqa: E731
    assert boundary(r) < boundary(unwelded)

    objs[0].vertices.requires_grad_(True)
    robjs[0].vertices.requires_grad_(True)
    img = pyredner.render(scene, num_samples=2, max_bounces=1, seed=SEED)
    img.sum().backward()
    rimg = rtt.render(rscene, rtt.RenderOptions(num_samples=2,
                                                max_bounces=1), seed=SEED)
    rimg.sum().backward()
    assert torch.equal(img, rimg)
    assert torch.equal(objs[0].vertices.grad, robjs[0].vertices.grad)
    assert float(objs[0].vertices.grad.abs().max()) > 0


def test_serialize_scene_and_render_function(cpu_default_device):
    """pyredner's two-call form: the leaves serialize_scene returns are the
    port scene's tensors, and RenderFunction.apply rebuilds the scene from
    those it is given."""
    scene, (verts, *_) = _scene(pyredner)
    args = pyredner.serialize_scene(scene, num_samples=2, max_bounces=1)
    port_scene = args[0].scene
    assert [id(x) for x in args[1:]] == [id(x) for x in
                                         scene_leaves(port_scene)]
    assert any(x is verts for x in args[1:])
    img = pyredner.RenderFunction.apply(SEED, *args)
    assert torch.equal(img, pyredner.render(scene, num_samples=2,
                                            max_bounces=1, seed=SEED))
    moved = [x + 0.1 if x is verts else x for x in args[1:]]
    assert not torch.equal(pyredner.RenderFunction.apply(SEED, args[0],
                                                         *moved), img)


@pytest.mark.parametrize("option", [
    dict(remat=True),
    dict(isect_replay_max_mb=64.0),
], ids=["remat", "isect_replay_max_mb"])
def test_render_passes_render_options(cpu_default_device, one_thread,
                                      monkeypatch, option):
    """Further RenderOptions fields reach redner_tpu_torch.render through
    pyredner.render, and give the gradient of the default options."""
    seen = []
    real = rtt.render

    def spy(scene, options, seed=0, engine=None):
        seen.append(options)
        return real(scene, options, seed=seed, engine=engine)

    monkeypatch.setattr(rtt, "render", spy)
    scene, leaves = _scene(pyredner, requires_grad=True)
    img0, base = _grads(pyredner, scene, leaves)
    for x in leaves:
        x.grad = None
    img = pyredner.render(scene, num_samples=2, max_bounces=1, seed=SEED,
                          **option)
    torch.sum(img * torch.as_tensor(_weight())).backward()
    (name, value), = option.items()
    assert getattr(seen[-1], name) == value != getattr(seen[0], name)
    assert np.array_equal(img.detach().numpy(), img0)
    for x, g in zip(leaves, base):
        assert np.array_equal(x.grad.numpy(), g)


def test_objects_go_to_the_default_device(cpu_default_device):
    """Lists and numpy arrays go to get_device(); a given tensor is moved
    with .to(), which keeps it when it is already there."""
    v = torch.tensor(TRI, requires_grad=True)
    s = pyredner.Shape(vertices=v, indices=np.array([[0, 1, 2]]))
    assert s.vertices is v
    assert s.indices.dtype == torch.int32
    t = pyredner.Texture(np.ones((2, 2, 3)))
    assert t.texels.device == pyredner.get_device() == torch.device("cpu")
    d = torch.tensor(DIFFUSE, dtype=torch.float64, requires_grad=True)
    m = pyredner.Material(diffuse_reflectance=d)
    assert m.diffuse_reflectance.texels.dtype == torch.float32
    m.diffuse_reflectance.texels.sum().backward()
    assert d.grad is not None  # moved with the differentiable .to()


def test_without_a_card_the_front_end_raises(monkeypatch):
    """Without set_device("cpu"), a front-end object needs the card: no
    fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rtt.set_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        pyredner.Camera(position=[0.0, 0.0, -5.0], look_at=[0.0, 0.0, 0.0],
                        up=[0.0, 1.0, 0.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        pyredner.generate_sphere(4, 8)
    assert pyredner.use_gpu() is False


@pytest.mark.parametrize("name,args", [
    ("gen_look_at_matrix", ([0.3, 1.0, -4.0], [0.0, 0.2, 0.0],
                            [0.0, 1.0, 0.1])),
    ("gen_translate_matrix", ([0.5, -1.0, 2.0],)),
    ("gen_scale_matrix", ([2.0, 0.5, 1.5],)),
    ("gen_rotate_matrix", ([0.3, -0.7, 1.1],)),
    ("gen_perspective", (45.0, 0.01, 100.0)),
])
def test_transforms_match_redner_torch(cpu_default_device, name, args):
    import redner_torch

    ours = getattr(pyredner, name)(*args)
    theirs = getattr(redner_torch, name)(*args)
    assert ours.shape == (4, 4) and ours.device.type == "cpu"
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_mesh_helpers_are_the_ports(cpu_default_device):
    """The front end's mesh helpers return the port's results, as tensors
    on the default device, differentiable where the port's are."""
    v, f, uv, n = pyredner.generate_sphere(6, 10)
    rv, rf, ruv, rn = rtt.generate_sphere(6, 10, device="cpu")
    assert f.dtype == torch.int32 and torch.equal(f.long(), rf)
    for a, b in ((v, rv), (uv, ruv), (n, rn)):
        assert torch.equal(a, b)
    v = v.clone().requires_grad_(True)
    normals = pyredner.compute_vertex_normal(v, f)
    assert torch.equal(normals, rtt.compute_vertex_normal(v, rf))
    smoothed = pyredner.smooth(v, f, 0.3)
    assert torch.equal(smoothed, rtt.smooth(v, rf, 0.3))
    (normals.sum() + smoothed.sum()).backward()
    assert v.grad is not None and bool(torch.isfinite(v.grad).all())
    uvs, uv_idx = pyredner.compute_uvs(v, f)
    assert uvs.shape == (3 * f.shape[0], 2) and uv_idx.shape == f.shape
    assert uv_idx.dtype == torch.int32


def test_files_through_the_front_end(cpu_default_device, one_thread,
                                     tmp_path):
    """load_mitsuba, imread, save_obj and save_mtl through the front end:
    the loaded scene renders as the port's loader's does (welds kept), the
    image reads as the port's, and a saved shape loads back."""
    from chip_smoke import write_files_scene

    xml = write_files_scene(str(tmp_path), res=(16, 16), theta=8, phi=16,
                            tex=16, env=(8, 16))
    scene = pyredner.load_mitsuba(xml)
    ref = rtt.load_mitsuba(xml, device="cpu")
    assert isinstance(scene, pyredner.Scene) and scene.envmap is not None
    assert scene.shapes[0].weld_ids is not None
    assert torch.equal(scene.shapes[0].weld_ids.long(), ref.shapes[0].weld_ids)
    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    img = pyredner.render(scene, num_samples=2, max_bounces=1, seed=SEED)
    assert torch.equal(img, rtt.render(ref, opts, seed=SEED))
    tex = pyredner.imread(str(tmp_path / "diffuse.exr"))
    assert torch.equal(tex, torch.as_tensor(
        rtt.imread(str(tmp_path / "diffuse.exr"))))
    pyredner.imwrite(tex, str(tmp_path / "copy.exr"))
    assert torch.equal(pyredner.imread(str(tmp_path / "copy.exr")), tex)

    shape = pyredner.Shape(vertices=TRI, indices=[[0, 1, 2]])
    pyredner.save_obj(shape, str(tmp_path / "tri.obj"))
    back = pyredner.load_obj(str(tmp_path / "tri.obj"), return_objects=True)
    np.testing.assert_allclose(back[0].vertices.numpy(), TRI, rtol=1e-6)
    assert torch.equal(back[0].indices, shape.indices)
    pyredner.save_mtl(pyredner.Material(diffuse_reflectance=DIFFUSE),
                      str(tmp_path / "m.mtl"))
    assert "Kd 0.5 0.4" in (tmp_path / "m.mtl").read_text()
    mats, meshes, lights = pyredner.load_obj(str(tmp_path / "tri.obj"))
    assert isinstance(next(iter(mats.values())), pyredner.Material)
    assert torch.equal(meshes[0][1].indices.long(), shape.indices.long())
    assert lights == {}
