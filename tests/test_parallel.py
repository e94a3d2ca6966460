"""Sharded rendering/training on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pathtracer_tpu as pt
from pathtracer_tpu import diff, inverse
from pathtracer_tpu.parallel import make_mesh, render_film_sharded
from pathtracer_tpu.parallel.shard import make_sharded_train_step


@pytest.fixture(scope="module")
def devices8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()


def test_mesh_factorization(devices8):
    mesh = make_mesh(8)
    assert mesh.shape["tile"] * mesh.shape["sample"] == 8
    mesh = make_mesh(8, tile=4)
    assert mesh.shape["tile"] == 4 and mesh.shape["sample"] == 2


def test_sharded_render_matches_single_device(devices8):
    cam, scene = pt.corner_scene(res=(16, 16))
    mesh = make_mesh(8, tile=2, sample=4)
    sharded = render_film_sharded(mesh, cam, scene, samples=8, depth=3)

    mesh1 = make_mesh(1)
    single = render_film_sharded(mesh1, cam, scene, samples=8, depth=3)
    np.testing.assert_allclose(np.asarray(sharded.data),
                               np.asarray(single.data), atol=1e-5)


def test_sharded_render_matches_diff_path(devices8):
    """The sharded film must equal the single-pass differentiable film —
    both trace global sample indices 0..spp-1 with the same streams."""
    cam, scene = pt.corner_scene(res=(16, 16))
    mesh = make_mesh(8, tile=4, sample=2)
    sharded = render_film_sharded(mesh, cam, scene, samples=8, depth=3)
    ref = diff.render_film_diff(cam, scene, diff.material_params(scene),
                                samples=8, depth=3)
    np.testing.assert_allclose(np.asarray(sharded.data), np.asarray(ref),
                               atol=1e-5)


def test_sharded_train_step_decreases_loss(devices8):
    cam, scene = pt.corner_scene(res=(16, 16))
    target = diff.render_film_diff(
        cam, scene, diff.material_params(scene), samples=16, depth=3,
        sample_offset=10_000)
    mesh = make_mesh(8, tile=2, sample=4)

    step, init = make_sharded_train_step(
        mesh, cam, scene, target, samples=8, depth=3,
        param_transform=inverse.to_materials)
    params = inverse.init_params(scene)
    opt_state = init(params)

    losses = []
    for k in range(20):
        params, opt_state, loss = step(params, opt_state, jnp.int32(k))
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses[:3] + losses[-3:]


def test_sharded_grads_replicated(devices8):
    """Gradients psum-ed over the mesh must be identical on every device
    (i.e. the returned update is replicated)."""
    cam, scene = pt.corner_scene(res=(8, 8))
    target = jnp.zeros((8, 8, 3))
    mesh = make_mesh(8, tile=2, sample=4)
    step, init = make_sharded_train_step(
        mesh, cam, scene, target, samples=8, depth=2,
        param_transform=inverse.to_materials)
    params = inverse.init_params(scene)
    opt_state = init(params)
    params, _, loss = step(params, opt_state, jnp.int32(0))
    assert np.isfinite(float(loss))
    # fully addressable replicated output == same value everywhere
    a = np.asarray(params["albedo"])
    assert np.all(np.isfinite(a))


def test_sharded_pallas_matches_single_device(devices8):
    """The megakernel sharded over the mesh (sample-axis data parallelism,
    film psum) is BIT-EXACT against the single-device kernel: the
    per-(pixel,sample) RNG streams make the per-device sample windows
    independent, and the psum adds the same partial sums the host loop
    would.  Interpret mode on the virtual CPU mesh."""
    from pathtracer_tpu.ops.pallas import trace_kernel
    from pathtracer_tpu.parallel.shard import render_film_sharded_pallas

    cam, scene = pt.cornell_box(res=(32, 30))  # 30 rows: not 8-bandable
    mesh = make_mesh(8)
    f = render_film_sharded_pallas(mesh, cam, scene, samples=8, depth=2,
                                   seed=7, interpret=True)
    ref = trace_kernel.render_film_pallas(cam, scene, 8, 2, seed=7,
                                          interpret=True, spp_per_call=1)
    np.testing.assert_allclose(np.asarray(f.data), np.asarray(ref.data),
                               rtol=1e-6, atol=1e-7)
    assert np.asarray(f.data).max() > 0


def test_sharded_pallas_banded_film(devices8):
    """Pixel-band sharding: with tile=4 x sample=2 every device renders
    only its own band (the kernel's h0 offset) and the psum runs over the
    sample axis only.  Agreement with the single-device kernel fails if
    ANY band index/offset is wrong — each band's rows must reproduce the
    exact global-(w,h) RNG streams."""
    from pathtracer_tpu.ops.pallas import trace_kernel
    from pathtracer_tpu.parallel.shard import render_film_sharded_pallas

    cam, scene = pt.cornell_box(res=(64, 64))
    mesh = make_mesh(8, tile=4, sample=2)
    f = render_film_sharded_pallas(mesh, cam, scene, samples=4, depth=2,
                                   seed=7, interpret=True)
    ref = trace_kernel.render_film_pallas(cam, scene, 4, 2, seed=7,
                                          interpret=True, spp_per_call=2)
    np.testing.assert_array_equal(np.asarray(f.data), np.asarray(ref.data))
    assert np.asarray(f.data).max() > 0  # non-vacuous


def test_sharded_pallas_needs_interpret_on_cpu(devices8):
    from pathtracer_tpu.parallel.shard import render_film_sharded_pallas

    cam, scene = pt.cornell_box(res=(16, 16))
    with pytest.raises(ValueError, match="interpret=True"):
        render_film_sharded_pallas(make_mesh(8), cam, scene, samples=8,
                                   depth=1, interpret=False)
