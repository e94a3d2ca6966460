"""The megakernel (ops/pallas/trace_kernel.py) against the XLA reference path.

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``),
which executes the same kernel body the GPU compiles.  The kernel follows
ops/trace.py operation by operation, so films match ``backend="brute"`` to
rounding (bit for bit at one sample per pixel; several samples differ in
the last bit because the kernel sums samples in another order).  The ``gpu``-marked tests compile it for the card and skip here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pathtracer_tpu as pt
from pathtracer_tpu.ops.pallas import trace_kernel as tk

from test_fuzz import _random_scene


def _scene(name, res=(16, 16)):
    if name == "corner":
        return pt.corner_scene(res=res)
    if name == "cornell":
        return pt.cornell_box(res=res)
    if name.startswith("mod"):
        return pt.modified_cornell(float(name[3:]), res=res)
    if name.startswith("fuzz"):
        cam, scene = _random_scene(int(name[4:]), 48)
        return dataclasses.replace(cam, res=res), scene
    raise ValueError(name)


def _kernel_film(cam, scene, spp, depth, seed=1, **kw):
    return np.asarray(tk.render_film_pallas(
        cam, scene, spp, depth, seed=seed, interpret=True, block=64,
        **kw).data)


def _brute_film(cam, scene, spp, depth, seed=1):
    return np.asarray(pt.render_film(cam, scene, samples=spp, depth=depth,
                                     seed=seed, backend="brute").data)


def test_pallas_matches_jnp_corner():
    cam, scene = pt.corner_scene(res=(16, 16))
    ref = pt.render_film(cam, scene, samples=4, depth=3, backend="brute")
    got = _kernel_film(cam, scene, 4, 3)
    np.testing.assert_allclose(got, np.asarray(ref.data), atol=2e-4)


def test_pallas_matches_jnp_cornell():
    cam, scene = pt.cornell_box(res=(16, 16))
    ref = pt.render_film(cam, scene, samples=2, depth=4, backend="brute")
    got = _kernel_film(cam, scene, 2, 4)
    np.testing.assert_allclose(got, np.asarray(ref.data), atol=2e-4)


def test_pallas_specular_scene():
    cam, scene = pt.modified_cornell(0.3, res=(16, 16))
    assert scene.has_specular
    ref = pt.render_film(cam, scene, samples=2, depth=3, backend="brute")
    got = _kernel_film(cam, scene, 2, 3)
    np.testing.assert_allclose(got, np.asarray(ref.data), atol=2e-4)


@pytest.mark.parametrize("seed", [1, 6])
@pytest.mark.parametrize("name", ["corner", "cornell", "mod0", "mod0.3",
                                  "mod0.8"])
def test_kernel_matches_brute(name, seed):
    cam, scene = _scene(name)
    ref = _brute_film(cam, scene, 2, 3, seed)
    got = _kernel_film(cam, scene, 2, 3, seed)
    assert ref.max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("depth,seed", [(1, 7), (2, 3), (5, 11)])
def test_kernel_depth_and_seed(depth, seed):
    cam, scene = _scene("cornell", res=(16, 8))
    ref = _brute_film(cam, scene, 2, depth, seed)
    got = _kernel_film(cam, scene, 2, depth, seed)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["fuzz11", "fuzz12", "fuzz13"])
def test_kernel_fuzz_scenes(name):
    cam, scene = _scene(name)
    ref = _brute_film(cam, scene, 2, 2, seed=5)
    got = _kernel_film(cam, scene, 2, 2, seed=5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["cornell", "corner"])
def test_kernel_mt_single_sample_bit_exact(name):
    """With one sample per pixel there is no sum to reorder: on diffuse
    scenes the kernel's Möller–Trumbore loop and the XLA path run the same
    operations on the same values.  (The specular sampler's longer expressions are fused
    differently by the CPU compiler and may round 1 ulp apart.)"""
    cam, scene = _scene(name)
    np.testing.assert_array_equal(
        _kernel_film(cam, scene, 1, 4, seed=2),
        _brute_film(cam, scene, 1, 4, seed=2))


def test_pallas_multi_call_accumulation():
    """spp split across kernel launches must equal a single launch."""
    cam, scene = pt.corner_scene(res=(16, 16))
    one = _kernel_film(cam, scene, 4, 3)
    split = _kernel_film(cam, scene, 4, 3, spp_per_call=1)
    np.testing.assert_allclose(one, split, atol=1e-6)


@pytest.mark.parametrize("res,block", [((13, 11), 64), ((20, 7), 32),
                                       ((5, 3), 128)])
def test_ragged_pixel_counts(res, block):
    """Pixel counts that are not a multiple of the block: the last block
    traces past the film and the wrapper crops."""
    cam, scene = pt.cornell_box(res=res)
    got = np.asarray(tk.render_film_pallas(
        cam, scene, 2, 2, seed=4, interpret=True, block=block).data)
    assert got.shape == (res[1], res[0], 3)
    np.testing.assert_allclose(got, _brute_film(cam, scene, 2, 2, 4),
                               rtol=1e-5, atol=1e-6)


def test_output_layout_channels():
    """Film is (H, W, 3) with channels in RGB order: a camera staring at
    an emitter reads exactly its emit color."""
    sb = pt.SceneBuilder()
    sb.add_triangle((-100, -100, 5), (100, -100, 5), (0, 100, 5),
                    pt.HostMaterial(pt.EMIT, emit=(0.25, 0.5, 0.75)))
    scene = sb.build()
    cam = pt.make_camera((0, 0, 0), (0, 0, 1), (0, 1, 0), (8, 4),
                         60 * pt.DEG2RAD, 1.0)
    got = _kernel_film(cam, scene, 2, 3)
    np.testing.assert_allclose(got, np.broadcast_to([0.25, 0.5, 0.75],
                                                    (4, 8, 3)), atol=1e-6)


@pytest.mark.parametrize("h0,band_h", [(0, 5), (5, 6), (11, 5)])
def test_band_rows_bit_identical(h0, band_h):
    """A band launch at row offset h0 reproduces the same rows of the full
    film bit for bit (the RNG streams depend on the global (w, h)) — the
    property band sharding relies on."""
    cam, scene = pt.cornell_box(res=(12, 16))
    full = np.asarray(tk.render_sum_pallas(cam, scene, 0, 2, 2, seed=9,
                                           interpret=True, block=32))
    packed = tk.PackedScene(cam, scene)
    ip = jnp.array([0, tk._seed_mix(9), 16, h0, 2], jnp.int32)
    band = np.asarray(packed.launch(ip, width=12, band_h=band_h, depth=2,
                                    interpret=True, block=32))
    np.testing.assert_array_equal(band, full[h0:h0 + band_h])


def test_sample_windows_compose():
    """Sums over adjacent sample windows add up to the combined window."""
    cam, scene = pt.corner_scene(res=(8, 8))
    a = tk.render_sum_pallas(cam, scene, 0, 2, 3, interpret=True, block=64)
    b = tk.render_sum_pallas(cam, scene, 2, 3, 3, interpret=True, block=64)
    ab = tk.render_sum_pallas(cam, scene, 0, 5, 3, interpret=True, block=64,
                              spp_per_call=2)
    np.testing.assert_allclose(np.asarray(a + b), np.asarray(ab), atol=1e-5)


def test_pallas_needs_interpret_on_cpu():
    cam, scene = pt.corner_scene(res=(8, 8))
    with pytest.raises(ValueError, match="interpret=True"):
        pt.render_film(cam, scene, 1, 1, backend="pallas")
    with pytest.raises(ValueError, match="interpret=True"):
        tk.render_film_pallas(cam, scene, 1, 1, interpret=False)


def test_kernel_argument_checks():
    cam, scene = pt.corner_scene(res=(8, 8))
    with pytest.raises(ValueError, match="power of two"):
        tk.render_film_pallas(cam, scene, 1, 1, interpret=True, block=48)
    from pathtracer_tpu import meshes
    _, sb = meshes.sphere_in_box(16, 32)
    with pytest.raises(ValueError, match="triangles"):
        tk.PackedScene(cam, sb.build())


@pytest.mark.parametrize("name", ["corner", "cornell", "mod0", "mod0.3"])
def test_kernel_lowers_for_cuda(name):
    """Every primitive of the kernel has a Triton lowering: the kernel
    lowers to a Triton module for CUDA here, without a GPU (compiling it
    to machine code needs the card; see the gpu-marked tests)."""
    cam, scene = _scene(name, res=(64, 32))
    packed = tk.PackedScene(cam, scene)
    ip = jnp.array([0, tk._seed_mix(1), 32, 0, 2], jnp.int32)
    lowered = tk._launch.trace(
        ip, packed.cam, packed.tri, packed.table, width=64, band_h=32,
        n_tris=packed.n_tris, depth=5, has_specular=packed.has_specular,
        block=tk.DEFAULT_BLOCK, num_warps=tk.DEFAULT_NUM_WARPS,
        interpret=False).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "pathtrace_megakernel" in text


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell", "mod0.05"])
def test_kernel_on_gpu_matches_brute(gpu_device, name):
    """The compiled kernel against brute on the card at 256^2: linear film
    means agree to 0.5 % (both estimate the same integral from the same
    RNG streams; they differ by FMA contraction and transcendental
    rounding, which can flip a handful of edge hits)."""
    del gpu_device
    cam, scene = _scene(name, res=(256, 256))
    got = np.asarray(pt.render_film(cam, scene, 32, 5, seed=3,
                                    backend="pallas").data)
    with jax.default_matmul_precision("highest"):
        ref = _brute_film(cam, scene, 32, 5, seed=3)
    assert np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-2)
    assert (rel > 1e-2).mean() < 1e-2
