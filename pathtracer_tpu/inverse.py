"""Inverse rendering: recover material parameters from a target image.

BASELINE.json config 5: "recover albedo/emission/roughness of Cornell box
from target image via pixel-gradient descent".  The optimizer works in an
unconstrained parameter space and maps into physical ranges:

    albedo    = sigmoid(p)        in (0, 1)^3
    emission  = softplus(p)       in (0, inf)^3
    roughness = sigmoid(p)        in (0, 1)

Gradients come from the detached/reparameterized estimator in diff.py; each
step traces a fresh set of sample indices (the global index advances by
``samples`` per step) so successive steps see independent Monte-Carlo noise,
which with Adam behaves like SGD on the true expected loss.

Runs single-device here; the multi-device variant is
``parallel.make_sharded_train_step`` (same math, grads psum-reduced).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import rng as prng
from .diff import render_film_diff
from .scene import Scene


def _softplus_inv(y):
    y = jnp.maximum(y, 1e-6)
    return y + jnp.log(-jnp.expm1(-y))


def _logit(y):
    y = jnp.clip(y, 1e-5, 1 - 1e-5)
    return jnp.log(y) - jnp.log1p(-y)


def to_unconstrained(mats: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
    return {
        "albedo": _logit(mats["albedo"]),
        "emit": _softplus_inv(mats["emit"]),
        "roughness": _logit(mats["roughness"]),
    }


def to_materials(params: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
    return {
        "albedo": jax.nn.sigmoid(params["albedo"]),
        "emit": jax.nn.softplus(params["emit"]),
        "roughness": jax.nn.sigmoid(params["roughness"]),
    }


def init_params(scene: Scene, value: float = 0.5) -> Dict[str, jnp.ndarray]:
    """Uniform 'grey' starting point with the scene's array shapes.

    Emission starts grey only on EMIT-type surfaces and ~zero elsewhere:
    material TYPES are structural scene knowledge (the reference scene
    format declares which surfaces are lights, material.h:27-39) — it is
    the continuous VALUES that are unknown.  Without this, the optimizer
    finds the emission-albedo degeneracy: a little emission painted on
    every wall explains the image as well as reflected light does, and
    albedos collapse (round-3 artifact: 0.36 mean albedo error at
    converged loss)."""
    T = scene.padded_size
    mtype, _, _, _ = scene.host_materials()
    from . import materials as mat
    is_emit = jnp.zeros((T, 1)).at[: scene.num_tris, 0].set(
        jnp.asarray(mtype == mat.EMIT, jnp.float32))
    e0 = _softplus_inv(jnp.float32(value))
    e_dark = _softplus_inv(jnp.float32(1e-6))
    return {
        "albedo": jnp.zeros((T, 3)) + _logit(jnp.float32(value)),
        "emit": jnp.zeros((T, 3)) + jnp.where(is_emit > 0, e0, e_dark),
        "roughness": jnp.zeros((T,)) + _logit(jnp.float32(value)),
    }


def recover_materials(
    camera,
    scene: Scene,
    target: jnp.ndarray,
    *,
    steps: int = 200,
    samples: int = 8,
    depth: int = 5,
    lr: float = 5e-2,
    lr_end: Optional[float] = None,
    seed: int = prng.SEED,
    params0: Optional[Dict[str, jnp.ndarray]] = None,
    optimize: tuple = ("albedo", "emit", "roughness"),
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 25,
    backend: str = "brute",
    loss: str = "paired",
    rel_eps: float = 2e-2,
    verbose: bool = False,
):
    """Gradient-descend material parameters to match ``target`` (linear film).

    ``optimize`` selects which parameter groups move; the rest stay frozen
    at their initial values.  Within a group, updates are further masked
    by material TYPE (structural scene knowledge): emission moves only on
    EMIT surfaces, roughness only on SPECULAR ones, albedo only on
    non-EMIT ones — this is what breaks the emission-vs-albedo
    degeneracy that round 3's recovery fell into.

    ``lr_end``: if set, the learning rate cosine-decays from ``lr`` to
    ``lr_end`` over ``steps`` — the Monte-Carlo gradient noise floor
    shrinks with the step size, so decay turns the terminal wander into
    convergence.

    ``loss``: "paired" (default) is the UNBIASED squared-error surrogate
    mean(w * (film_A - target) * (film_B - target)) over two independent
    half-sample renders, with relative weights w = 1/(target+rel_eps)^2.
    Any loss nonlinear in the noisy film estimate — "mse", "relative",
    "sqrt" (kept for ablation) — pays E[(f-t)^2] = (Ef-t)^2 + Var(f),
    and darker materials mean shorter, lower-variance paths, so those
    objectives systematically DARKEN the recovery (they plateau at
    0.20-0.36 visible-albedo error on the Cornell box no matter how long
    they run — the round-3 artifact).  The paired product's expectation
    is exactly (Ef-t)^2: with it the same budget reaches < 0.05.
    The relative weighting matters too: linear radiance spans orders of
    magnitude and plain MSE under-weights dark pixels (measured 44%-dark
    convergence).

    ``checkpoint``: path to a .npz resume file; if present, training
    resumes at the recorded step (params + Adam state restored — each step
    k draws the sample window k*samples, so the continued trajectory is
    the one the uninterrupted run would have taken); it is (re)written
    every ``checkpoint_every`` steps and at the end.

    Returns (materials, losses): the recovered physical material arrays and
    the per-step loss history (of the steps run in THIS call).
    """
    import os

    import optax

    from . import materials as mat_mod
    from . import policy
    from .diff import make_accel
    from .utils import checkpoint as ckpt

    backend = policy.resolve(backend, scene, differentiable=True)
    accel = make_accel(scene, backend)
    if lr_end is not None:
        sched = optax.cosine_decay_schedule(lr, max(steps, 1),
                                            alpha=lr_end / lr)
        opt = optax.adam(sched)
    else:
        opt = optax.adam(lr)
    params = params0 if params0 is not None else init_params(scene)
    opt_state = opt.init(params)
    frozen = {k: (0.0 if k in optimize else 1.0) for k in params}
    # per-row type masks (1.0 where the parameter is physically active)
    T = scene.padded_size
    mtype = scene.host_materials()[0]
    row = {
        "albedo": np.asarray(mtype != mat_mod.EMIT, np.float32),
        "emit": np.asarray(mtype == mat_mod.EMIT, np.float32),
        "roughness": np.asarray(mtype == mat_mod.SPECULAR, np.float32),
    }
    type_mask = {}
    for k, r in row.items():
        full = np.zeros(T, np.float32)
        full[: scene.num_tris] = r
        m = jnp.asarray(full)
        type_mask[k] = m if params[k].ndim == 1 else m[:, None]

    # Resuming with a different backend (or scene) would silently continue
    # with a different gradient estimator; record both and abort on
    # mismatch, like render_film's checkpoint meta validation.
    meta = {"samples": samples, "depth": depth, "seed": seed,
            "backend": backend, "loss": loss,
            "scene_sum": float(scene.host_verts()[0].sum()
                               + scene.host_materials()[1].sum())}
    start_step = 0
    if checkpoint is not None:
        cpath = checkpoint if checkpoint.endswith(".npz") \
            else checkpoint + ".npz"
        if os.path.exists(cpath):
            params, opt_state, start_step, saved = ckpt.load_train_checkpoint(
                cpath, params, opt_state)
            if saved != meta:
                raise ValueError(
                    f"checkpoint {cpath} was written by a different "
                    f"training config:\n  saved: {saved}\n  this:  {meta}")
            if verbose:
                print(f"Resuming at step {start_step}/{steps}.")

    if loss not in ("paired", "relative", "mse", "sqrt"):
        raise ValueError(f"unknown loss {loss!r} "
                         f"(use 'paired', 'relative', 'sqrt' or 'mse')")
    if loss == "paired" and samples < 2:
        raise ValueError(
            "loss='paired' needs samples >= 2 (two independent half-sample "
            f"renders; got samples={samples})")
    wgt = (1.0 / (jnp.asarray(target) + rel_eps) ** 2
           if loss in ("relative", "paired") else 1.0)
    tgt_s = jnp.sqrt(jnp.asarray(target) + rel_eps)
    loss_kind = loss  # the name 'loss' is re-bound inside step()
    # Roughness gradients are BOUNDARY-DOMINATED: radiance depends on
    # roughness mainly through WHICH surface the blurred reflection hits,
    # a discrete function the pathwise (reparameterized) derivative
    # cannot see.  Measured on the modified Cornell at rough=0.5: the
    # pathwise gradient is wrong-signed and ~200x smaller than the
    # finite-difference slope of the expected loss (and the naive score
    # -function/REINFORCE fix is INVALID for the uniform-cube jitter —
    # its support moves with roughness, which drops exactly the boundary
    # term; measured equally wrong-signed).  The expected paired loss IS
    # smooth and sharply minimized at the truth (scanned), so roughness
    # coordinates use two-point SPSA with common random numbers instead:
    # unbiased for the smoothed landscape, and the shared sample window
    # cancels the Monte-Carlo noise in the difference.
    rough_spsa = "roughness" in optimize and scene.has_specular
    spsa_eps = 0.15  # logit-space perturbation (~0.04 at rough 0.5)

    def step(params, opt_state, k):
        def loss_fn(p):
            half = max(samples // 2, 1) if loss_kind == "paired" else samples
            film = render_film_diff(
                camera, scene, to_materials(p), half, depth,
                seed=seed, sample_offset=k * samples,
                backend=backend, accel=accel)
            if loss_kind == "paired":
                # Any loss NONLINEAR in the noisy film estimate is biased
                # by its Monte-Carlo variance: E[(f - t)^2] =
                # (E f - t)^2 + Var(f), and darker materials make shorter
                # (lower-variance) paths, so plain MSE/relative/sqrt
                # objectives systematically DARKEN the recovery (measured:
                # visible-albedo error plateaus at 0.20-0.25 on the
                # Cornell box however long you optimize).  The classic
                # cure: two INDEPENDENT half-sample estimates A, B give
                # E[(A - t)(B - t)] = (E f - t)^2 exactly — an unbiased
                # surrogate for the true squared error, with an unbiased
                # gradient.  Same cost: each half uses samples/2.
                film_b = render_film_diff(
                    camera, scene, to_materials(p), samples - half, depth,
                    seed=seed, sample_offset=k * samples + half,
                    backend=backend, accel=accel)
                return jnp.mean(wgt * (film - target) * (film_b - target))
            if loss_kind == "sqrt":
                # variance-stabilizing tonemap: the MC noise of linear
                # radiance is ~Poisson (std ~ sqrt(mean)), so sqrt-space
                # residuals have ~uniform noise across the dynamic range
                # (NOTE: biased by Var(film) — kept for ablation)
                return jnp.mean(
                    (jnp.sqrt(jnp.maximum(film, 0.0) + rel_eps)
                     - tgt_s) ** 2)
            return jnp.mean(wgt * (film - target) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(params)
        if rough_spsa:
            key = jax.random.fold_in(
                jax.random.PRNGKey(seed ^ 0x5B57A), k)
            delta = jnp.where(
                jax.random.bernoulli(key, 0.5,
                                     params["roughness"].shape),
                1.0, -1.0) * type_mask["roughness"]
            pp = {**params, "roughness": params["roughness"]
                  + spsa_eps * delta}
            pm = {**params, "roughness": params["roughness"]
                  - spsa_eps * delta}
            g_r = (loss_fn(pp) - loss_fn(pm)) / (2.0 * spsa_eps) * delta
            g = {**g, "roughness": g_r}
        updates, opt_state = opt.update(g, opt_state, params)
        updates = {k: u * (1.0 - frozen[k]) * type_mask[k]
                   for k, u in updates.items()}
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    step = jax.jit(step)

    losses = []
    for k in range(start_step, steps):
        params, opt_state, loss = step(params, opt_state, jnp.int32(k))
        losses.append(float(loss))
        if verbose and (k % 10 == 0 or k == steps - 1):
            print(f"step {k:4d}  loss {losses[-1]:.3e}")
        if checkpoint is not None and (
                (k + 1) % checkpoint_every == 0 or k == steps - 1):
            ckpt.save_train_checkpoint(
                checkpoint, params, opt_state, k + 1, meta)
    return to_materials(params), np.asarray(losses)
