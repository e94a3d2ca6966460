#!/usr/bin/env python
"""Headline throughput benchmarks vs the reference (BASELINE.md), one JSON
line.  Needs an NVIDIA GPU; fails without one.

Workloads (all depth 5 unless BENCH_DEPTH says otherwise):
  * cornell1024  — diffuse Cornell box, 1024^2 (reference: 112 s for 10k
    spp on its GPU => ~4.68e8 rays/s, README.md:25-29).
  * specular1024 — modified Cornell (specular walls, roughness 0.05),
    1024^2 (reference: 230 s avg => ~2.28e8 rays/s, README.md:35-39).
  * sphere9812 / garden105708 — the 9,812- and 105,708-triangle scenes at
    256^2 through the GPU's BVH traversal.  The reference GPU path cannot
    run them at all (uniform arrays cap at MAX_TRIANGLES=300, shader.h:76);
    its Cornell throughput is the only available anchor.

Every render goes through ``backend="auto"`` (policy.py).  Each metric is
the median of BENCH_REPEATS (default 5) runs after one warm-up; a timed
region ends with a host fetch of the film, so the number includes
readback.  The device kind and the card's power limit are printed beside
the numbers: a card set below its maximum power runs slower under load.
"""

import json
import os
import subprocess
import sys
import time

BASE_CORNELL = 5.24288e10 / 112.0   # ~4.68e8 rays/s (README.md:25-29)
BASE_SPECULAR = 5.24288e10 / 230.0  # ~2.28e8 rays/s (README.md:35-39)


def require_gpu():
    """(device, nvidia-smi name/power-limit line); exits without a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU: the first JAX device is {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {dev.device_kind} x {len(jax.devices())}; {card}",
          file=sys.stderr, flush=True)
    return dev, card


def measure(render, rays, repeats=None):
    """Median of N fetch-fenced steady-state runs; returns
    (median_rays_per_sec, spread_dict)."""
    import numpy as np
    if repeats is None:
        repeats = max(1, int(os.environ.get("BENCH_REPEATS", "5")))
    np.asarray(render().data)  # compile + warm-up
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        np.asarray(render().data)  # fence: host fetch
        rates.append(rays / (time.perf_counter() - t0))
    rates.sort()
    n = len(rates)
    med = (rates[n // 2] if n % 2
           else 0.5 * (rates[n // 2 - 1] + rates[n // 2]))
    return med, {"runs": n, "min": rates[0], "max": rates[-1],
                 "spread": (rates[-1] - rates[0]) / med if med else 0.0}


def main():
    import dataclasses

    dev, card = require_gpu()
    import pathtracer_tpu as pt
    from pathtracer_tpu import meshes, policy

    depth = int(os.environ.get("BENCH_DEPTH", "5"))
    spp = int(os.environ.get("BENCH_SPP", "4096"))
    results = []

    for name, (cam, scene), base in (
            ("cornell1024", pt.cornell_box(res=(1024, 1024)), BASE_CORNELL),
            ("specular1024", pt.modified_cornell(0.05, res=(1024, 1024)),
             BASE_SPECULAR)):
        rps, sp = measure(
            lambda: pt.render_film(cam, scene, samples=spp, depth=depth),
            1024 * 1024 * spp * depth)
        results.append({"metric": f"rays_per_sec_{name}", "value": rps,
                        "unit": "rays/s", "vs_baseline": rps / base,
                        "backend": policy.choose_backend(scene),
                        "timing": sp})

    bres = int(os.environ.get("BENCH_BVH_RES", "256"))
    bspp = int(os.environ.get("BENCH_BVH_SPP", "64"))
    for make in (lambda: meshes.sphere_in_box(50, 100), meshes.mesh_garden):
        cam, sb = make()
        scene = sb.build()
        cam = dataclasses.replace(cam, res=(bres, bres))
        bvh = pt.build_bvh(scene)
        rps, sp = measure(
            lambda: pt.render_film(cam, scene, samples=bspp, depth=depth,
                                   bvh=bvh),
            bres * bres * bspp * depth)
        results.append({
            "metric": f"rays_per_sec_{scene.num_tris}tris_{bres}",
            "value": rps, "unit": "rays/s",
            "vs_baseline": rps / BASE_CORNELL,
            "backend": policy.choose_backend(scene), "timing": sp})

    head = dict(results[0])
    head["extra"] = results[1:]
    head["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                      "card": card}
    print(json.dumps(head))


if __name__ == "__main__":
    main()
