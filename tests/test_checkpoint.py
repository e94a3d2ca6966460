"""Checkpoint/resume tests."""

import os

import jax.numpy as jnp
import numpy as np
import optax

import pathtracer_tpu as pt
from pathtracer_tpu import diff, inverse
from pathtracer_tpu.utils import checkpoint as ckpt


def test_render_checkpoint_roundtrip(tmp_path, rng_np):
    film = rng_np.random((8, 8, 3)).astype(np.float32)
    path = os.path.join(tmp_path, "r.npz")
    ckpt.save_render_checkpoint(path, film, 123, {"spp": 512, "depth": 5})
    f2, done, meta = ckpt.load_render_checkpoint(path)
    np.testing.assert_array_equal(film, f2)
    assert done == 123 and meta["spp"] == 512


def test_train_checkpoint_roundtrip(tmp_path):
    _, scene = pt.corner_scene(res=(8, 8))
    params = inverse.init_params(scene)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    path = os.path.join(tmp_path, "t.npz")
    ckpt.save_train_checkpoint(path, params, opt_state, 7, {"lr": 1e-2})
    p2, o2, step, meta = ckpt.load_train_checkpoint(path, params, opt_state)
    assert step == 7 and meta["lr"] == 1e-2
    np.testing.assert_array_equal(np.asarray(params["albedo"]),
                                  np.asarray(p2["albedo"]))
    # optimizer state trees match leaf-for-leaf
    import jax
    l1 = jax.tree_util.tree_leaves(opt_state)
    l2 = jax.tree_util.tree_leaves(o2)
    assert len(l1) == len(l2)
    for a, b in zip(l1, l2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resumed_render_matches_uninterrupted():
    """film_sum checkpointing + independent per-sample streams => resuming
    at sample k gives the identical final film."""
    cam, scene = pt.corner_scene(res=(8, 8))
    params = diff.material_params(scene)
    full = diff.render_film_diff(cam, scene, params, samples=8, depth=3)
    part1 = diff.render_film_diff(cam, scene, params, samples=4, depth=3,
                                  sample_offset=0)
    part2 = diff.render_film_diff(cam, scene, params, samples=4, depth=3,
                                  sample_offset=4)
    resumed = (np.asarray(part1) * 4 + np.asarray(part2) * 4) / 8
    np.testing.assert_allclose(np.asarray(full), resumed, atol=1e-6)


def test_render_film_kill_resume_bit_identical(tmp_path, monkeypatch):
    """The integrated path: render_film is aborted mid-run (checkpoint on
    disk), re-invoked with the same arguments, and must produce a film
    BIT-IDENTICAL to an uninterrupted run."""
    import pytest

    import importlib

    render_mod = importlib.import_module("pathtracer_tpu.render")

    # Shrink the per-pass plan so this tiny render spans several schedule
    # entries (at production sizes one entry is ~16M rays).
    monkeypatch.setattr(render_mod, "_plan",
                        lambda *a, **k: (16, 8, 2))  # tile_h, spp_b, blocks

    cam, scene = pt.cornell_box(res=(16, 16))
    path = os.path.join(tmp_path, "render_ck.npz")

    uninterrupted = pt.render_film(cam, scene, samples=64, depth=3,
                                   backend="brute")

    with pytest.raises(KeyboardInterrupt):
        pt.render_film(cam, scene, samples=64, depth=3, backend="brute",
                       checkpoint=path, _abort_after=1)
    assert os.path.exists(path)
    _, done, _ = ckpt.load_render_checkpoint(path)
    assert 0 < done < 64

    resumed = pt.render_film(cam, scene, samples=64, depth=3,
                             backend="brute", checkpoint=path)
    np.testing.assert_array_equal(np.asarray(resumed.data),
                                  np.asarray(uninterrupted.data))


def test_render_film_checkpoint_config_mismatch(tmp_path):
    import pytest

    cam, scene = pt.corner_scene(res=(8, 8))
    path = os.path.join(tmp_path, "ck.npz")
    with pytest.raises(KeyboardInterrupt):
        pt.render_film(cam, scene, samples=16, depth=3, backend="brute",
                       checkpoint=path, _abort_after=1)
    with pytest.raises(ValueError, match="different render config"):
        pt.render_film(cam, scene, samples=16, depth=4, backend="brute",
                       checkpoint=path)


def test_recover_materials_kill_resume(tmp_path):
    """Training resumes at the recorded step with restored Adam state: the
    continued trajectory equals the uninterrupted one step-for-step."""
    cam, scene = pt.corner_scene(res=(8, 8))
    params = diff.material_params(scene)
    target = diff.render_film_diff(cam, scene, params, samples=16, depth=2,
                                   sample_offset=10_000)
    kw = dict(steps=6, samples=4, depth=2, optimize=("albedo",))

    mats_full, losses_full = inverse.recover_materials(
        cam, scene, jnp.asarray(target), **kw)

    path = os.path.join(tmp_path, "train_ck.npz")
    inverse.recover_materials(cam, scene, jnp.asarray(target),
                              checkpoint=path, checkpoint_every=3,
                              steps=3, samples=4, depth=2,
                              optimize=("albedo",))
    mats_res, losses_res = inverse.recover_materials(
        cam, scene, jnp.asarray(target), checkpoint=path,
        checkpoint_every=3, **kw)

    assert len(losses_res) == 3  # steps 3..5 only
    np.testing.assert_allclose(losses_res, losses_full[3:], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(mats_res["albedo"]),
                               np.asarray(mats_full["albedo"]), atol=1e-5)


def test_pallas_kill_resume_bit_identical(tmp_path):
    """backend='pallas' + checkpoint must NOT fall back to the slow tile
    driver; the megakernel checkpoints at sample-window boundaries and
    resumes bit-identically (interpret mode on the CPU)."""
    import pytest

    from pathtracer_tpu.render import _render_pallas_checkpointed

    cam, scene = pt.cornell_box(res=(32, 32))
    path = os.path.join(tmp_path, "p.npz")

    full = _render_pallas_checkpointed(
        cam, scene, samples=8, depth=3, seed=5,
        checkpoint=os.path.join(tmp_path, "full.npz"), block_spp=2,
        interpret=True)

    with pytest.raises(KeyboardInterrupt):
        _render_pallas_checkpointed(cam, scene, samples=8, depth=3, seed=5,
                                    checkpoint=path, block_spp=2,
                                    interpret=True, _abort_after=2)
    z = np.load(path)
    assert int(z["samples_done"]) == 4
    resumed = _render_pallas_checkpointed(
        cam, scene, samples=8, depth=3, seed=5, checkpoint=path,
        block_spp=2, interpret=True)
    np.testing.assert_array_equal(np.asarray(full.data),
                                  np.asarray(resumed.data))

    # mismatched config aborts instead of silently mixing estimators
    with pytest.raises(ValueError, match="different render config"):
        _render_pallas_checkpointed(cam, scene, samples=8, depth=4, seed=5,
                                    checkpoint=path, block_spp=2,
                                    interpret=True)
