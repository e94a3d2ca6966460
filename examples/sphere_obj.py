#!/usr/bin/env python
"""Large-mesh scene through the OBJ + BVH pipeline (BASELINE config 4).

Generates a ~10k-triangle sphere-in-room mesh, writes it to OBJ/MTL,
re-imports it with the OBJ loader, builds the SAH BVH, and renders it
(auto backend: a BVH traversal, see policy.py) — the workload class the
reference GPU cannot run at all (its uniform arrays cap at
MAX_TRIANGLES=300, shader.h:76).

Usage: python examples/sphere_obj.py out.png [--res 256] [--spp 64]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses

import pathtracer_tpu as pt
from pathtracer_tpu import meshes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("filename")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--n-lat", type=int, default=50)
    ap.add_argument("--n-lon", type=int, default=100)
    ap.add_argument("--backend", default="auto",
                    help="auto: the platform's BVH traversal (policy.py); "
                         "or 'bvh' / 'bvh-gather' / 'brute'")
    args = ap.parse_args()

    cam, sb = meshes.sphere_in_box(args.n_lat, args.n_lon)
    with tempfile.TemporaryDirectory() as d:
        obj = os.path.join(d, "scene.obj")
        meshes.save_obj(sb, obj)
        scene = pt.load_obj_scene(obj, mtl_path=d)
    print(f"{scene.num_tris} triangles via OBJ round-trip")

    cam = dataclasses.replace(cam, res=(args.res, args.res))
    bvh = pt.build_bvh(scene)
    print(f"BVH: {bvh.num_nodes} nodes, depth {bvh.depth}, "
          f"max leaf {bvh.max_leaf}")
    pt.render(cam, scene, args.spp, args.depth, args.filename, bvh=bvh,
              backend=args.backend)


if __name__ == "__main__":
    main()
