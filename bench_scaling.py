#!/usr/bin/env python
"""Scaling benchmark: rays/s of the sharded renderers across mesh sizes
(1, 2, 4, ... GPUs of one host).  Needs NVIDIA GPUs; fails without one.

Two paths, each over the same mesh sizes: ``render_film_sharded`` (the
XLA dense path) and ``render_film_sharded_pallas`` (the megakernel with
pixel-band sharding).  Prints one JSON line per (path, mesh size), with
the device kind and the card's power limit on stderr.
"""

import argparse
import json
import time

from bench import require_gpu


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--depth", type=int, default=5)
    args = ap.parse_args()

    require_gpu()
    import jax
    import numpy as np

    import pathtracer_tpu as pt
    from pathtracer_tpu.parallel import make_mesh, render_film_sharded
    from pathtracer_tpu.parallel.shard import render_film_sharded_pallas

    n = len(jax.devices())
    cam, scene = pt.cornell_box(res=(args.res, args.res))
    rays = args.res * args.res * args.spp * args.depth
    paths = {
        "xla_sharded": render_film_sharded,
        "pallas_sharded": lambda *a, **k: render_film_sharded_pallas(
            *a, interpret=False, **k),
    }
    results = []
    for name, fn in paths.items():
        base = None
        size = 1
        while size <= n:
            mesh = make_mesh(size)
            np.asarray(fn(mesh, cam, scene, samples=args.spp,
                          depth=args.depth).data)  # compile + warm-up
            t0 = time.perf_counter()
            np.asarray(fn(mesh, cam, scene, samples=args.spp,
                          depth=args.depth).data)
            dt = time.perf_counter() - t0
            r = {"path": name, "devices": size, "mesh": dict(mesh.shape),
                 "rays_per_sec": rays / dt, "seconds": dt}
            if base is None:
                base = rays / dt
            else:
                r["scaling_efficiency"] = (rays / dt) / (base * size)
            results.append(r)
            print(json.dumps(r), flush=True)
            size *= 2
    return results


if __name__ == "__main__":
    main()
