#!/usr/bin/env python3
"""Smoke test of the path tracer on NVIDIA GPUs, through its user entry
points, in ONE process (a second JAX process on the card would fail for
want of device memory).

    python chip_smoke.py            # one card: phases 1-9 below
    python chip_smoke.py --cards 4  # four cards: the sharded render and
                                    # train step only, against one card

Phases (one card), each printing its own result lines; any failure exits
non-zero and no phase carries on past its own failure:

  1. device      the first JAX device is a GPU (no CPU fallback); prints the
                 device kind and count and nvidia-smi's name and power limit
  2. cornell     ``cli.main(["render", "cornell", ...])`` at 1024^2, 256 spp,
                 depth 5; the policy must have run the megakernel, whose
                 linear film is compared with backend="brute" on the card;
                 the kernel's compiled memory_analysis() is printed
  3. specular    modified_cornell(0.05) at 1024^2, checked the same way
  4. golden      Cornell 64^2, 256 spp, seed 11 through both paths against
                 the CPU snapshot tests/goldens/cornell64_cpu256_seed11.npz
  5. large       the 9,812- and 105,708-triangle scenes at 256^2 through
                 "auto" (the GPU's BVH traversal); the 9.8k film against
                 brute on the card, and the packet traversal "bvh" against
                 brute there too; BVH build time and time to first image
  6. diff        jitted recover_materials steps on the Cornell box, and one
                 value-and-grad step on the 9.8k scene through "auto" (the
                 GPU's BVH traversal) and through "bvh", each checked
                 against brute's loss and gradients
  7. realtime    a RealtimeSession for a few frames
  8. gpu tests   the tests marked ``gpu``, in-process (pytest -m gpu)
  9. last line   {"ok": true, "device": {...}} as JAX reports the device

Tolerances (every reference render runs under
``jax.default_matmul_precision("highest")``).  The megakernel and brute
trace the same paths from the same RNG streams; they differ only by FMA
contraction and the libdevice transcendentals, which can flip a ray-edge
test and send that one path elsewhere.  So:

  * linear film means agree to MEAN_RTOL (0.5 %);
  * the share of pixels whose value differs by more than PIX_RTOL (5 %,
    relative to max(|ref|, 0.05)) stays under PIX_FRAC (1 %): a flipped
    path moves one pixel by up to its full value, while a wrong kernel
    moves most pixels;
  * against the CPU snapshot, gamma-space PSNR above GOLDEN_PSNR (40 dB):
    a render that samples, intersects or shades differently lands near
    the 26 dB Monte-Carlo floor, far below;
  * gradients (and the loss) of a BVH traversal against brute's to
    GRAD_RTOL (1e-3) in relative L1: both sum the same paths, and differ
    by the order of the scatter-add sums (about 1e-7, and not the same
    from run to run), while a wrong traversal or gradient rule moves
    every triangle's entry.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

MEAN_RTOL = 5e-3
PIX_RTOL = 5e-2
PIX_FLOOR = 5e-2
PIX_FRAC = 1e-2
GOLDEN_PSNR = 40.0
GRAD_RTOL = 1e-3
SHARD_RTOL = 1e-5  # psum / host-loop summation order only


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_info() -> str:
    """nvidia-smi's name and power limit, from a child that does not
    import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def compare(phase, got, ref):
    """Film agreement under the module's stated tolerances."""
    import numpy as np

    got, ref = np.asarray(got), np.asarray(ref)
    check(got.shape == ref.shape, f"shape {got.shape} != {ref.shape}")
    check(np.isfinite(got).all(), "non-finite pixels")
    mean_rel = abs(float(got.mean()) - float(ref.mean())) / float(ref.mean())
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), PIX_FLOOR)
    frac = float((rel > PIX_RTOL).mean())
    log(phase, f"mean {got.mean():.6f} vs ref {ref.mean():.6f} "
               f"(rel {mean_rel:.2e}, limit {MEAN_RTOL}); pixels off by "
               f">{PIX_RTOL:.0%}: {frac:.2e} (limit {PIX_FRAC}); "
               f"max abs diff {np.abs(got - ref).max():.3e}")
    check(ref.mean() > 0, "reference film is black")
    check(mean_rel <= MEAN_RTOL, f"film means differ by {mean_rel:.3e}")
    check(frac <= PIX_FRAC, f"{frac:.3e} of pixels differ")


def timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def kernel_memory(phase, cam, scene, depth=5):
    """Print what XLA reports of the megakernel's memory, compiled for the
    card at the film's full size (the render before it has compiled this
    shape already, so the executable comes from JAX's cache)."""
    import jax.numpy as jnp

    from pathtracer_tpu.ops.pallas import trace_kernel as tk

    packed = tk.PackedScene(cam, scene)
    width, height = cam.res
    iparams = jnp.array([0, tk._seed_mix(1), height, 0, 1], jnp.int32)
    compiled = tk._launch.lower(
        iparams, packed.cam, packed.tri, packed.table, width=width,
        band_h=height, n_tris=packed.n_tris, depth=depth,
        has_specular=packed.has_specular,
        block=tk.DEFAULT_BLOCK, num_warps=tk.DEFAULT_NUM_WARPS,
        interpret=False).compile()
    log(phase, f"megakernel ({width}x{height}) memory: "
               f"{compiled.memory_analysis()}")


def brute_film(cam, scene, spp, depth=5, seed=1):
    import jax
    import numpy as np

    import pathtracer_tpu as pt

    with jax.default_matmul_precision("highest"):
        return np.asarray(pt.render_film(cam, scene, spp, depth, seed=seed,
                                         backend="brute").data)


class KernelSpy:
    """Records the linear films the megakernel returns, so a render driven
    through the CLI can be checked (the CLI gamma-corrects in place)."""

    def __init__(self):
        from pathtracer_tpu.ops.pallas import trace_kernel

        self.module = trace_kernel
        self.original = trace_kernel.render_film_pallas
        self.films = []

    def __enter__(self):
        import numpy as np

        def spy(*args, **kwargs):
            film = self.original(*args, **kwargs)
            self.films.append(np.array(film.data))
            return film

        self.module.render_film_pallas = spy
        return self

    def __exit__(self, *exc):
        self.module.render_film_pallas = self.original


def phase_cornell(out_dir):
    import pathtracer_tpu as pt
    from pathtracer_tpu import cli, policy

    res, spp = 1024, 256
    cam, scene = pt.cornell_box(res=(res, res))
    check(policy.choose_backend(scene) == "pallas",
          f"policy chose {policy.choose_backend(scene)!r}, not the kernel")
    png = os.path.join(out_dir, "cornell.png")
    with KernelSpy() as spy:
        _, dt = timed(lambda: cli.main(
            ["render", "cornell", png, "--res", str(res),
             "--spp", str(spp)]))
    check(len(spy.films) == 1, "the CLI render did not run the megakernel")
    check(os.path.getsize(png) > 0, "no PNG written")
    log("cornell", f"cli render {res}^2 x {spp} spp, depth 5, through the "
                   f"megakernel: {dt:.2f} s (compile included)")
    kernel_memory("cornell", cam, scene)
    ref, dt = timed(lambda: brute_film(cam, scene, spp))
    log("cornell", f"brute reference on the card: {dt:.2f} s")
    compare("cornell", spy.films[0], ref)


def phase_specular():
    import pathtracer_tpu as pt
    from pathtracer_tpu import policy

    res, spp = 1024, 256
    cam, scene = pt.modified_cornell(0.05, res=(res, res))
    check(policy.choose_backend(scene) == "pallas", "policy skipped kernel")
    film, dt = timed(lambda: pt.render_film(cam, scene, spp, 5).data)
    log("specular", f"modified_cornell(0.05) {res}^2 x {spp} spp through "
                    f"'auto': {dt:.2f} s (compile included)")
    kernel_memory("specular", cam, scene)
    compare("specular", film, brute_film(cam, scene, spp))


def phase_golden():
    import numpy as np

    import pathtracer_tpu as pt

    snap_path = os.path.join(ROOT, "tests", "goldens",
                             "cornell64_cpu256_seed11.npz")
    snap = np.load(snap_path)["linear"]
    cam, scene = pt.cornell_box(res=(64, 64))

    def gamma(x):
        return np.clip(x, 0, 1) ** (1 / 2.2)

    films = {
        "pallas": np.asarray(pt.render_film(cam, scene, 256, 5, seed=11,
                                            backend="pallas").data),
        "brute": brute_film(cam, scene, 256, seed=11),
    }
    for name, film in films.items():
        p = pt.psnr(gamma(film), gamma(snap))
        rel = abs(film.mean() - snap.mean()) / snap.mean()
        log("golden", f"{name}: PSNR vs CPU snapshot {p:.2f} dB (limit "
                      f"{GOLDEN_PSNR}), linear mean rel diff {rel:.2e} "
                      f"(limit {MEAN_RTOL})")
        check(p > GOLDEN_PSNR, f"{name} drifted from the CPU snapshot")
        check(rel <= MEAN_RTOL, f"{name} mean off the CPU snapshot")


def _large_scenes():
    import dataclasses

    from pathtracer_tpu import meshes

    out = {}
    for name, make in (("sphere9812", lambda: meshes.sphere_in_box(50, 100)),
                       ("garden105708", meshes.mesh_garden)):
        cam, sb = make()
        out[name] = (dataclasses.replace(cam, res=(256, 256)), sb.build())
    return out


def phase_large(scenes):
    import numpy as np

    import pathtracer_tpu as pt
    from pathtracer_tpu import policy

    spp = 16
    for name, (cam, scene) in scenes.items():
        backend = policy.choose_backend(scene)
        bvh, t_build = timed(lambda: pt.build_bvh(scene))
        film, t_first = timed(lambda: pt.render_film(
            cam, scene, spp, 5, bvh=bvh).data)
        film = np.asarray(film)
        log("large", f"{name} ({scene.num_tris} tris) 256^2 x {spp} spp via "
                     f"'auto' -> {backend!r}: BVH build {t_build:.2f} s, "
                     f"first image {t_first:.2f} s (compile included)")
        check(np.isfinite(film).all() and film.max() > 0,
              f"{name} film is black or non-finite")
        if name == "sphere9812":
            compare("large", film, brute_film(cam, scene, spp))
            # the packet traversal takes a host round trip per while-loop
            # step on a GPU, so one sample per pixel
            film, dt = timed(lambda: pt.render_film(
                cam, scene, 1, 5, bvh=bvh, backend="bvh").data)
            log("large", f"{name} 256^2 x 1 spp via 'bvh': {dt:.2f} s "
                         f"(compile included)")
            compare("large", film, brute_film(cam, scene, 1))


def phase_diff(scenes):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    import pathtracer_tpu as pt
    from pathtracer_tpu import diff, inverse, policy

    cam, scene = pt.cornell_box(res=(64, 64))
    target = jnp.asarray(np.asarray(pt.render_film(cam, scene, 64, 4,
                                                   seed=5).data))
    mats, losses = inverse.recover_materials(
        cam, scene, target, steps=4, samples=8, depth=4,
        optimize=("albedo", "emit"))
    log("diff", f"recover_materials on the Cornell box: losses "
                f"{[f'{x:.3e}' for x in losses]}")
    check(np.isfinite(losses).all(), "non-finite loss")
    check(all(np.isfinite(np.asarray(v)).all() for v in mats.values()),
          "non-finite materials")

    # "bvh" shares one traversal stack per 8192-ray packet: on a GPU each
    # of its while-loop steps costs a host round trip, so keep this to
    # one packet (32^2 x 2 spp)
    cam, scene = scenes["sphere9812"]
    cam = dataclasses.replace(cam, res=(32, 32))
    check(policy.choose_backend(scene, differentiable=True)
          == policy.GPU_LARGE_SCENE, "policy skipped the GPU's BVH path")
    params = diff.material_params(scene)
    results = {}
    for backend in ("brute", "auto", "bvh"):
        loss = diff.make_loss(cam, scene, jnp.zeros((32, 32, 3)), samples=2,
                              depth=5, backend=backend)
        with jax.default_matmul_precision("highest"):
            (val, grads), dt = timed(
                lambda: jax.jit(jax.value_and_grad(loss))(params))
        val = float(val)
        grads = {k: np.asarray(g) for k, g in grads.items()}
        gnorm = {k: float(np.abs(g).sum()) for k, g in grads.items()}
        log("diff", f"9.8k scene value-and-grad through {backend!r}: loss "
                    f"{val:.7e}, |grad| {gnorm}, {dt:.2f} s")
        check(np.isfinite(val), "non-finite loss")
        check(all(np.isfinite(g).all() for g in grads.values()),
              "non-finite gradient")
        check(gnorm["albedo"] > 0 and gnorm["emit"] > 0, "zero gradient")
        results[backend] = val, grads
    ref_val, ref = results.pop("brute")
    for backend, (val, grads) in results.items():
        errs = {k: float(np.abs(grads[k] - ref[k]).sum()
                         / np.abs(ref[k]).sum()) for k in ("albedo", "emit")}
        log("diff", f"{backend!r} vs brute: loss rel diff "
                    f"{abs(val - ref_val) / ref_val:.2e}, gradient rel L1 "
                    f"diff {errs} (limit {GRAD_RTOL})")
        check(abs(val - ref_val) <= GRAD_RTOL * ref_val,
              f"{backend!r} loss differs from brute")
        check(max(errs.values()) <= GRAD_RTOL,
              f"{backend!r} gradients differ from brute")


def phase_realtime(out_dir):
    import numpy as np

    import pathtracer_tpu as pt

    cam, scene = pt.cornell_box(res=(256, 256))
    sess = pt.RealtimeSession(cam, scene, depth=5, frame_samples=4,
                              screenshot_dir=out_dir)
    check(sess.backend == "pallas", f"realtime chose {sess.backend!r}")
    for key in ("", "w", "", ""):
        if key:
            sess.key(key)
        img, dt = timed(sess.step)
        log("realtime", f"frame {sess.frame}: {dt * 1e3:.1f} ms")
    check(sess.frame == 3, f"frame counter {sess.frame}")
    check(np.isfinite(img).all() and img.max() > 0, "black frame")


def phase_gpu_tests():
    import pytest

    os.environ["PATHTRACER_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(ROOT, "tests")])
    log("gpu tests", f"pytest -m gpu exit code {int(rc)}")
    check(int(rc) == 0, "gpu-marked tests failed")


def run_one_card():
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    phases = [
        ("cornell", lambda: phase_cornell(out_dir)),
        ("specular", phase_specular),
        ("golden", phase_golden),
    ]
    scenes = {}
    phases += [
        ("large", lambda: (scenes.update(_large_scenes()),
                           phase_large(scenes))),
        ("diff", lambda: phase_diff(scenes)),
        ("realtime", lambda: phase_realtime(out_dir)),
        ("gpu tests", phase_gpu_tests),
    ]
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        log(name, f"passed in {time.perf_counter() - t0:.1f} s")


def run_four_cards():
    """The sharded paths on a 2x2 (tile, sample) mesh against one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import pathtracer_tpu as pt
    from pathtracer_tpu import diff, inverse
    from pathtracer_tpu.ops.pallas import trace_kernel
    from pathtracer_tpu.parallel import make_mesh, render_film_sharded
    from pathtracer_tpu.parallel.shard import (make_sharded_train_step,
                                               render_film_sharded_pallas)

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} GPUs, need 4")
    mesh = make_mesh(4, tile=2, sample=2)
    one = make_mesh(1)
    cam, scene = pt.cornell_box(res=(512, 512))
    spp = 64

    def agree(name, got, ref):
        got, ref = np.asarray(got), np.asarray(ref)
        err = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref),
                                                          1e-3)))
        log("4 cards", f"{name}: max rel diff vs one card {err:.2e} "
                       f"(limit {SHARD_RTOL}), mean {got.mean():.6f}")
        check(np.isfinite(got).all() and got.mean() > 0, f"{name} black")
        check(err <= SHARD_RTOL, f"{name} differs from the one-card film")

    with jax.default_matmul_precision("highest"):
        film4, dt = timed(lambda: render_film_sharded(
            mesh, cam, scene, spp, 5).data)
        log("4 cards", f"render_film_sharded 2x2 {dt:.2f} s")
        agree("render_film_sharded", film4,
              render_film_sharded(one, cam, scene, spp, 5).data)
    film4, dt = timed(lambda: render_film_sharded_pallas(
        mesh, cam, scene, spp, 5, interpret=False).data)
    log("4 cards", f"render_film_sharded_pallas 2x2 {dt:.2f} s")
    agree("render_film_sharded_pallas", film4,
          trace_kernel.render_film_pallas(cam, scene, spp, 5,
                                          interpret=False).data)

    cam, scene = pt.cornell_box(res=(64, 64))
    target = diff.render_film_diff(cam, scene, diff.material_params(scene),
                                   16, 4, sample_offset=10_000)
    step, init = make_sharded_train_step(
        mesh, cam, scene, target, samples=8, depth=4,
        param_transform=inverse.to_materials)
    params = inverse.init_params(scene)
    params, _, loss = step(params, init(params), jnp.int32(0))
    check(np.isfinite(float(loss)), "non-finite sharded loss")
    for k, leaf in params.items():
        shards = [np.asarray(s.data) for s in leaf.addressable_shards]
        check(len(shards) == 4, f"{k}: {len(shards)} shards")
        check(all(np.array_equal(s, shards[0]) for s in shards),
              f"{k}: updated params (so gradients) differ across devices")
    log("4 cards", f"sharded train step: loss {float(loss):.4e}, updated "
                   f"parameters identical on all 4 devices")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded paths on four cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    try:
        import pathtracer_tpu
    except ImportError as e:
        print(f"FAIL: pathtracer_tpu is not next to this script ({e})",
              flush=True)
        return 1
    if os.path.dirname(os.path.dirname(pathtracer_tpu.__file__)) != ROOT:
        print("FAIL: imported pathtracer_tpu from outside this checkout",
              flush=True)
        return 1

    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:
        devices = []
        print(f"jax found no devices: {e}", flush=True)
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        print(f"FAIL: no GPU (first JAX device platform: {plat})",
              flush=True)
        return 1
    dev = devices[0]
    log("device", f"{dev.platform} {dev.device_kind} x {len(devices)}")
    # nvidia-smi's own lines (name, power limit), one per card
    print(card_info(), flush=True)

    try:
        if args.cards == 4:
            run_four_cards()
        else:
            run_one_card()
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
