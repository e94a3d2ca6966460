"""Command-line interface.

The reference's "CLI" is recompile-the-example (SURVEY.md L6: hard-coded
scenes, single output-filename argument).  This is a real one:

    python -m pathtracer_tpu render cornell out.png --res 512 --spp 1024
    python -m pathtracer_tpu render scene.obj out.png --camera 0,1,5:0,0,-1
    python -m pathtracer_tpu sweep modified-cornell out_prefix --spp 1000
    python -m pathtracer_tpu realtime cornell shots/ --frames 30 --keys w,a,p
    python -m pathtracer_tpu invert cornell --steps 200 --res 64
    python -m pathtracer_tpu bench [--backend pallas]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import policy


def _parse_camera(spec, res):
    from .camera import make_camera
    from .linalg import DEG2RAD

    parts = spec.split(":")
    pos = tuple(float(x) for x in parts[0].split(","))
    fwd = tuple(float(x) for x in parts[1].split(","))
    up = tuple(float(x) for x in parts[2].split(",")) if len(parts) > 2 \
        else (0, 1, 0)
    fov = float(parts[3]) if len(parts) > 3 else 60.0
    return make_camera(pos, fwd, up, res, fov * DEG2RAD, 1.0)


def _load_scene(name, res, camera_spec=None, roughness=0.0):
    from . import scene as scene_mod
    from .obj_loader import load_obj_scene

    if name == "cornell":
        cam, sc = scene_mod.cornell_box(res=res)
    elif name == "modified-cornell":
        cam, sc = scene_mod.modified_cornell(roughness, res=res)
    elif name == "corner":
        cam, sc = scene_mod.corner_scene(res=res)
    elif name.endswith(".obj"):
        sc = load_obj_scene(name)
        if camera_spec is None:
            raise SystemExit("--camera is required for OBJ scenes")
        cam = None
    else:
        raise SystemExit(f"unknown scene: {name}")
    if camera_spec:
        cam = _parse_camera(camera_spec, res)
    return cam, sc


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pathtracer_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene to PNG")
    p.add_argument("scene")
    p.add_argument("filename")
    p.add_argument("--res", type=int, default=512)
    p.add_argument("--spp", type=int, default=256)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--backend", default="auto",
                   choices=list(policy.RENDER_BACKENDS))
    p.add_argument("--camera", help="pos:forward[:up[:fov_deg]] e.g. "
                                    "'278,278,-500:0,0,1'")
    p.add_argument("--roughness", type=float, default=0.0)
    p.add_argument("--checkpoint", help="resume file (.npz): created if "
                   "missing, resumed from if present")

    p = sub.add_parser("sweep", help="modified-Cornell roughness sweep")
    p.add_argument("prefix")
    p.add_argument("--res", type=int, default=1024)
    p.add_argument("--spp", type=int, default=10000)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--backend", default="auto")

    p = sub.add_parser("realtime", help="progressive render, scripted keys")
    p.add_argument("scene")
    p.add_argument("screenshot_dir")
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--frame-samples", type=int, default=15)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--keys", default="", help="comma list, one per frame")
    p.add_argument("--camera")
    p.add_argument("--interactive", action="store_true",
                   help="live ANSI terminal viewer with raw-key controls "
                        "(wasd/space/z move, ijkl rotate, r reset, p "
                        "screenshot, q quit); needs a tty")

    p = sub.add_parser("invert", help="inverse-rendering demo")
    p.add_argument("scene")
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--target-spp", type=int, default=2048,
                   help="target-image quality: the target's own noise "
                        "floors the recovery, so it renders at high spp "
                        "through the fast production kernels")
    p.add_argument("--lr", type=float, default=0.08)
    p.add_argument("--loss", default="paired",
                   choices=["paired", "relative", "sqrt", "mse"],
                   help="'paired' is the unbiased squared-error "
                        "surrogate (see inverse.py)")
    p.add_argument("--checkpoint", help="resume file (.npz): created if "
                   "missing, resumed from if present")
    p.add_argument("--backend", default="auto",
                   choices=list(policy.DIFF_BACKENDS),
                   help="intersection backend for the differentiable "
                        "renders (auto: brute for small scenes, a BVH "
                        "traversal for OBJ-scale; see policy.py)")

    p = sub.add_parser("bench", help="headline throughput benchmark")
    p.add_argument("--res", type=int, default=1024)
    p.add_argument("--spp", type=int, default=512)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--backend", default="auto",
                   choices=list(policy.RENDER_BACKENDS))

    args = ap.parse_args(argv)

    if args.cmd == "render":
        from .render import render
        cam, sc = _load_scene(args.scene, (args.res, args.res), args.camera,
                              args.roughness)
        render(cam, sc, args.spp, args.depth, args.filename,
               seed=args.seed, backend=args.backend,
               checkpoint=args.checkpoint)

    elif args.cmd == "sweep":
        from . import scene as scene_mod
        from .render import render
        for r in (0, 0.05, 0.1, 0.3, 0.5, 0.8):
            cam, sc = scene_mod.modified_cornell(r, res=(args.res, args.res))
            render(cam, sc, args.spp, args.depth,
                   f"{args.prefix}{r:g}.png", backend=args.backend)

    elif args.cmd == "realtime":
        cam, sc = _load_scene(args.scene, (args.res, args.res), args.camera)
        if args.interactive:
            from .realtime import run_interactive
            sess = run_interactive(cam, sc, args.depth, args.frame_samples,
                                   screenshot_dir=args.screenshot_dir)
        else:
            from .realtime import render_realtime
            sess = render_realtime(cam, sc, args.depth, args.frame_samples,
                                   args.screenshot_dir, frames=args.frames,
                                   keys=args.keys)
        print(sess.title)

    elif args.cmd == "invert":
        import jax.numpy as jnp
        from . import diff
        from .inverse import recover_materials
        cam, sc = _load_scene(args.scene, (args.res, args.res))
        backend = policy.resolve(args.backend, sc, differentiable=True)
        print("rendering target...")
        from .render import render_film
        target = jnp.asarray(np.asarray(render_film(
            cam, sc, samples=args.target_spp, depth=args.depth,
            seed=101, backend="auto").data))
        print("optimizing materials...")
        mats, losses = recover_materials(
            cam, sc, target, steps=args.steps,
            samples=args.spp, depth=args.depth, backend=backend,
            lr=args.lr, lr_end=args.lr * 0.05, loss=args.loss,
            checkpoint=args.checkpoint, verbose=True)
        true_alb = np.asarray(sc.albedo)[: sc.num_tris]
        got_alb = np.asarray(mats["albedo"])[: sc.num_tris]
        err = np.abs(true_alb - got_alb).mean()
        print(f"final loss {losses[-1]:.3e}; mean |albedo error| {err:.4f}")

    elif args.cmd == "bench":
        import json
        import time
        from .render import render_film
        from . import scene as scene_mod
        cam, sc = scene_mod.cornell_box(res=(args.res, args.res))
        render_film(cam, sc, samples=32, depth=args.depth,
                    backend=args.backend)  # warmup
        t0 = time.perf_counter()
        render_film(cam, sc, samples=args.spp, depth=args.depth,
                    backend=args.backend)
        dt = time.perf_counter() - t0
        rays = args.res * args.res * args.spp * args.depth
        import jax
        dev = jax.devices()[0]
        print(json.dumps({"rays_per_sec": rays / dt, "seconds": dt,
                          "backend": policy.resolve(args.backend, sc),
                          "device": {"platform": dev.platform,
                                     "kind": dev.device_kind}}))


if __name__ == "__main__":
    main()
