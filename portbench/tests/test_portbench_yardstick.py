"""The yardstick's arithmetic, by hand on small cases."""

import statistics

import pytest
import torch

from portbench import yardstick as ys


def _launch(ntile, nchunks, live_lanes):
    n = ntile * ys.TILE_N
    R = torch.zeros((n, 10))
    tmin = torch.zeros(n)
    tmax = torch.ones(n)
    live = torch.zeros(n, dtype=torch.bool)
    live[:live_lanes] = True
    return R, tmin, tmax, live


def test_work_bound_counts_tests_by_hand():
    # 600 triangles: a full chunk of 512 and a tail chunk of 88.
    R, tmin, tmax, live = _launch(2, 2, 130)  # tile 0 full, tile 1 two lanes
    mask = torch.tensor([[True, True], [False, True]])
    bound, by, tests = ys.work_bound(600, 1024 * 20, R, tmin, tmax, live,
                                     mask, count=3)
    assert tests == 128 * (512 + 88) + 2 * 88
    assert by == "operations"
    assert bound == pytest.approx(tests * 48 / 67e12)
    # Any hit: tile 0 settles after its first chunk, tile 1 after none.
    _, _, tests = ys.work_bound(600, 1024 * 20, R, tmin, tmax, live, mask,
                                count=3, steps=torch.tensor([1, 0]))
    assert tests == 128 * 512


def test_work_bound_of_an_empty_launch_is_its_bytes():
    R, tmin, tmax, live = _launch(1, 1, 0)
    mask = torch.zeros((1, 1), dtype=torch.bool)
    bound, by, tests = ys.work_bound(3, 20, R, tmin, tmax, live, mask, 0)
    assert tests == 0 and by == "bytes"
    nbytes = 4 * (128 * 10 + 128 + 128 + 20 + 0 + 1 + 2 * 128)
    assert bound == pytest.approx(nbytes / 3.35e12)


def test_settle_steps_match_the_port_plain_any_hit():
    """The yardstick's settle count equals the chunks that the port's
    plain any-hit sweep visits on the same launch inputs."""
    import redner_tpu_torch as rtt
    from redner_tpu_torch.core.types import Ray
    from redner_tpu_torch.ops import intersect as port_plain
    from redner_tpu_torch.ops import intersect_cuda as ic
    from redner_tpu_torch.scene import flatten_scene

    cam = rtt.make_camera(position=[0, 0, -3], look_at=[0, 0, 0],
                          up=[0, 1, 0], fov=45.0, resolution=(8, 8),
                          device="cpu")
    v, f, uv, n = rtt.generate_sphere(24, 48, device="cpu")  # > 1 chunk
    mat = rtt.make_material(diffuse_reflectance=[0.5, 0.5, 0.5],
                            device="cpu")
    scene = rtt.scene_from_objects(cam, [rtt.Object(v, f, mat, uvs=uv,
                                                    normals=n)])
    fs = flatten_scene(scene)
    g = torch.Generator().manual_seed(3)
    org = torch.randn((700, 3), generator=g) * 3
    d = torch.nn.functional.normalize(-org + 0.3 * torch.randn(
        (700, 3), generator=g), dim=-1)
    ray = Ray(org=org, dir=d, tmin=torch.full((700,), 1e-3),
              tmax=torch.full((700,), 10.0))
    rb = ic.prepare_rays(fs, ray)
    want = port_plain.anyhit_plain(fs.layout.Tc, rb)[1]
    got = ys.anyhit_settle_steps(fs.layout.Tc, rb.R, rb.tmin, rb.tmax,
                                 rb.mask)
    assert fs.layout.Tc.shape[0] > 1
    assert torch.equal(got, want)


def test_idle_share_counts_overlapping_kernels_once():
    kern = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0),
            ("d", 9.5, 11.0)]
    busy, gaps = ys.busy_and_gaps(kern, 0.0, 10.0)
    assert busy == pytest.approx(3.0 + 1.0 + 0.5)
    assert gaps == [(3.0, 5.0), (6.0, 9.5)]
    assert ys.idle_share(busy, 10.0) == pytest.approx(0.55)


def test_p95_is_taken_over_every_frame():
    # 19 fast frames and one slow one, in chunks of 5: the medians of the
    # chunks never see the slow frame, the 95th percentile of all does.
    lat = [10.0] * 19 + [100.0]
    chunk_medians = [statistics.median(lat[i:i + 5])
                     for i in range(0, 20, 5)]
    assert max(chunk_medians) == 10.0
    assert ys.p95(lat) == pytest.approx(statistics.quantiles(lat, n=20)[18])
    assert ys.p95(lat) > 50.0
