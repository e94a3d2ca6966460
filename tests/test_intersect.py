"""Intersection correctness: dense brute-force and BVH traversal versus a
scalar transcription of Möller–Trumbore (triangle.h:25-44)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import pathtracer_tpu as pt
from pathtracer_tpu.linalg import EPS, FLOAT_INF
from pathtracer_tpu.ops import intersect as isect
from pathtracer_tpu.scene import SceneBuilder, Diffuse


def scalar_moller_trumbore(o, d, v1, v2, v3):
    """Straight-line scalar port of triangle.h:25-44 for oracle checks."""
    e1, e2 = v2 - v1, v3 - v1
    h = np.cross(d, e2)
    a = np.dot(e1, h)
    if abs(a) < EPS:
        return None
    f = 1.0 / a
    s = o - v1
    u = f * np.dot(s, h)
    if u < 0 or u > 1:
        return None
    q = np.cross(s, e1)
    v = f * np.dot(d, q)
    if v < 0 or u + v > 1:
        return None
    t = f * np.dot(e2, q)
    return t if t > 0 else None


def _random_scene(rng_np, n_tris=33):
    sb = SceneBuilder()
    for _ in range(n_tris):
        base = rng_np.uniform(-5, 5, 3)
        sb.add_triangle(base, base + rng_np.normal(0, 1, 3),
                        base + rng_np.normal(0, 1, 3), Diffuse(1))
    return sb.build()


def _brute_oracle(scene, o, d):
    n = scene.num_tris
    v1 = np.asarray(scene.v1)[:n]
    v2 = np.asarray(scene.v2)[:n]
    v3 = np.asarray(scene.v3)[:n]
    best_t, best_i = FLOAT_INF, -1
    for i in range(n):
        t = scalar_moller_trumbore(o, d, v1[i], v2[i], v3[i])
        if t is not None and t < best_t:
            best_t, best_i = t, i
    return best_t, best_i


def test_brute_matches_scalar_oracle(rng_np):
    scene = _random_scene(rng_np)
    R = 64
    o = rng_np.uniform(-8, 8, (R, 3)).astype(np.float32)
    d = rng_np.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    t, tid = isect.intersect_brute(
        jnp.asarray(o), jnp.asarray(d), scene.v1, scene.v2, scene.v3)
    t, tid = np.asarray(t), np.asarray(tid)

    for r in range(R):
        et, ei = _brute_oracle(scene, o[r], d[r])
        assert tid[r] == ei, f"ray {r}: {tid[r]} != {ei}"
        if ei >= 0:
            np.testing.assert_allclose(t[r], et, rtol=1e-4)


def test_padding_triangles_never_hit(rng_np):
    scene = _random_scene(rng_np, n_tris=5)  # padded to 8
    assert scene.padded_size == 8
    o = rng_np.uniform(-8, 8, (128, 3)).astype(np.float32)
    d = rng_np.normal(size=(128, 3)).astype(np.float32)
    _, tid = isect.intersect_brute(
        jnp.asarray(o), jnp.asarray(d), scene.v1, scene.v2, scene.v3)
    assert np.all(np.asarray(tid) < 5)


def test_ray_through_cornell_hits_tall_box():
    # The center-ish ray from the camera passes through the tall box's front
    # face (the 5th tall-box quad, our triangles 30/31) before the back wall.
    cam, scene = pt.cornell_box(res=(4, 4))
    assert scene.num_tris == 32  # 16 quads (cornell_box.cc adds 32 tris)
    o = jnp.array([[278.0, 278.0, -500.0]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    t, tid = isect.intersect_brute(o, d, scene.v1, scene.v2, scene.v3)
    assert int(tid[0]) in (30, 31)
    np.testing.assert_allclose(float(t[0]), 791.968, rtol=1e-4)

    # A ray aimed above the tall box (slope 0.2: clears the box at y=330,
    # stays under the ceiling at the back) reaches the back wall (tris 6/7).
    d2 = jnp.array([[0.0, 0.2, 1.0]]) / np.sqrt(1 + 0.2**2)
    t2, tid2 = isect.intersect_brute(o, d2, scene.v1, scene.v2, scene.v3)
    assert int(tid2[0]) in (6, 7)


def test_aabb_hit_matches_reference_semantics():
    # aabb.h:20-29: hit iff tmin <= tmax and tmax >= 0.
    lb = jnp.array([[0.0, 0, 0]])
    rt = jnp.array([[1.0, 1, 1]])
    o = jnp.array([[-1.0, 0.5, 0.5]])
    inv = 1.0 / jnp.array([[1.0, 1e-9, 1e-9]])
    assert bool(isect.aabb_hit(o, inv, lb, rt)[0])
    # behind the origin -> miss
    o2 = jnp.array([[2.0, 0.5, 0.5]])
    assert not bool(isect.aabb_hit(o2, inv, lb, rt)[0])


def test_bvh_matches_brute(rng_np):
    scene = _random_scene(rng_np, n_tris=200)
    bvh = pt.build_bvh(scene, use_native=False)
    R = 256
    o = rng_np.uniform(-8, 8, (R, 3)).astype(np.float32)
    d = rng_np.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    tb, ib = isect.intersect_brute(
        jnp.asarray(o), jnp.asarray(d), scene.v1, scene.v2, scene.v3)
    tv, iv = isect.intersect_bvh(
        jnp.asarray(o), jnp.asarray(d), bvh, scene.v1, scene.v2, scene.v3,
        max_leaf=bvh.max_leaf, stack_size=bvh.stack_size())

    np.testing.assert_array_equal(np.asarray(ib), np.asarray(iv))
    np.testing.assert_allclose(np.asarray(tb), np.asarray(tv), rtol=1e-5)


def test_bvh_packet_matches_brute(rng_np):
    scene = _random_scene(rng_np, n_tris=200)
    bvh = pt.build_bvh(scene, use_native=False)
    R = 256
    o = rng_np.uniform(-8, 8, (R, 3)).astype(np.float32)
    d = rng_np.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    tb, ib = isect.intersect_brute(
        jnp.asarray(o), jnp.asarray(d), scene.v1, scene.v2, scene.v3)
    # multi-packet path (R=256 -> 4 packets of 64) and single-packet path
    for pr in (64, 4096):
        tp, ip = isect.intersect_bvh_packet(
            jnp.asarray(o), jnp.asarray(d), bvh, scene.v1, scene.v2,
            scene.v3, max_leaf=bvh.max_leaf, stack_size=bvh.stack_size(),
            packet_rays=pr)
        np.testing.assert_array_equal(np.asarray(ib), np.asarray(ip))
        np.testing.assert_allclose(np.asarray(tb), np.asarray(tp), rtol=1e-5)


@pytest.mark.parametrize("seed,n_tris,n_rays", [(1, 50, 128), (2, 300, 256),
                                                (3, 1200, 512)])
def test_bvh_packet_matches_per_ray_stack(seed, n_tris, n_rays):
    """The two XLA traversals the GPU policy chooses between — packets
    sharing one stack ('bvh') and one stack per ray ('bvh-gather') — visit
    the same leaves and return the same (t, tid)."""
    r = np.random.default_rng(seed)
    scene = _random_scene(r, n_tris=n_tris)
    bvh = pt.build_bvh(scene)
    o = jnp.asarray(r.uniform(-8, 8, (n_rays, 3)).astype(np.float32))
    d = r.normal(size=(n_rays, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    kw = dict(max_leaf=bvh.max_leaf, stack_size=bvh.stack_size())
    tg, ig = isect.intersect_bvh(o, d, bvh, scene.v1, scene.v2, scene.v3,
                                 **kw)
    tp, ip = isect.intersect_bvh_packet(o, d, bvh, scene.v1, scene.v2,
                                        scene.v3, packet_rays=64, **kw)
    assert (np.asarray(ig) >= 0).any()
    np.testing.assert_array_equal(np.asarray(ip), np.asarray(ig))
    np.testing.assert_array_equal(np.asarray(tp), np.asarray(tg))


def test_render_bvh_vs_bvh_gather_film():
    """Whole renders through both traversals are the same film."""
    from pathtracer_tpu import meshes

    cam, sb = meshes.sphere_in_box(8, 16)
    scene = sb.build()
    cam = dataclasses.replace(cam, res=(16, 16))
    bvh = pt.build_bvh(scene)
    a = pt.render_film(cam, scene, 2, 3, bvh=bvh, backend="bvh")
    b = pt.render_film(cam, scene, 2, 3, bvh=bvh, backend="bvh-gather")
    assert np.asarray(a.data).max() > 0
    np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))


@pytest.mark.gpu
def test_bvh_traversals_agree_on_gpu(gpu_device):
    """Both traversals compiled for the card return the same hits."""
    del gpu_device
    test_bvh_packet_matches_per_ray_stack(3, 1200, 512)
