"""Randomized cross-backend agreement sweep.

The fixed-scene bit-exactness tests (test_pallas, test_bvh) pin the
canonical fixtures; this sweep throws seeded RANDOM geometry at every
intersection backend — thin slivers, overlapping triangles, boxes the
camera sits inside, mixed material types — where traversal edge cases
(tie-breaking at equal t, degenerate determinants, leaf boundaries)
actually live.  Depth-1 radiance is a pure function of the nearest hit +
camera jitter, so brute/bvh/bvh-gather/pallas must agree BIT FOR BIT on
every scene.
"""

import numpy as np
import pytest

import pathtracer_tpu as pt
from pathtracer_tpu.camera import make_camera
from pathtracer_tpu.linalg import DEG2RAD
from pathtracer_tpu.scene import Diffuse, Emit, SceneBuilder, Specular


def _random_scene(seed, n_tris):
    r = np.random.default_rng(seed)
    sb = SceneBuilder()
    # one guaranteed emitter so depth-1 images are non-vacuous
    sb.add_quad(((4, 9.5, 2), (4, 9.5, 6), (-4, 9.5, 6), (-4, 9.5, 2)),
                Emit(1.0, 0.9, 0.8))
    for i in range(n_tris - 2):
        c = r.uniform(-8, 8, 3)
        # mix of scales down to slivers
        scale = 10.0 ** r.uniform(-2, 0.8)
        v = c + r.normal(size=(3, 3)) * scale
        kind = r.integers(0, 4)
        if kind == 0:
            m = Emit(*r.uniform(0.2, 1.5, 3))
        elif kind == 3:
            m = Specular(float(r.uniform(0, 0.6)), *r.uniform(0.1, 0.9, 3))
        else:
            m = Diffuse(*r.uniform(0.05, 0.95, 3))
        sb.add_triangle(tuple(v[0]), tuple(v[1]), tuple(v[2]), m)
    # an axis-aligned triangle (axis-parallel rays hit d == 0 slab paths)
    sb.add_triangle((0, -2, 0), (3, -2, 0), (0, -2, 3), Diffuse(0.5, 0.5, 0.5))
    scene = sb.build()
    pos = r.uniform(-14, 14, 3)
    centroid = np.asarray(scene.v1)[: scene.num_tris].mean(axis=0)
    fwd = centroid - pos  # look AT the geometry: non-vacuous images
    cam = make_camera(tuple(pos), tuple(fwd), (0, 1, 0), (32, 32),
                      70 * DEG2RAD, 1.0)
    return cam, scene


@pytest.mark.parametrize("seed,n_tris", [(11, 24), (12, 64), (13, 160)])
def test_fuzz_depth1_all_backends_bit_exact(seed, n_tris):
    from pathtracer_tpu.bvh import build_bvh

    cam, scene = _random_scene(seed, n_tris)
    ref = np.asarray(pt.render_film(cam, scene, samples=2, depth=1,
                                    seed=seed, backend="brute").data)
    assert ref.max() > 0, "fuzz scene renders all-black; weak test"
    bvh = build_bvh(scene)
    for backend in ("bvh", "bvh-gather", "pallas"):
        got = np.asarray(pt.render_film(
            cam, scene, samples=2, depth=1, seed=seed, bvh=bvh,
            backend=backend, interpret=True).data)
        np.testing.assert_array_equal(got, ref, err_msg=backend)


def test_fuzz_deep_bounce_brute_vs_bvh_bit_exact():
    """Depth-3 renders through brute and BVH traversal are the SAME
    estimator over the same RNG streams — any hit disagreement anywhere
    along any bounce chain changes the image, so bit-equality here
    fuzzes the traversal against multi-bounce ray distributions (not
    just coherent camera rays).  Pallas-vs-brute deep equivalence is
    covered by test_pallas on the fixtures; interpret-mode spp loops
    are too slow for random-scene sweeps."""
    cam, scene = _random_scene(21, 48)
    a = np.asarray(pt.render_film(cam, scene, samples=24, depth=3,
                                  seed=5, backend="brute").data)
    b = np.asarray(pt.render_film(cam, scene, samples=24, depth=3,
                                  seed=5, backend="bvh").data)
    assert a.max() > 0
    np.testing.assert_array_equal(b, a)
