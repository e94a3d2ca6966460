"""Fused path-tracing megakernel for NVIDIA GPUs (Pallas, Triton route).

The GPU re-design of the reference's GLSL fragment-shader megakernel
(shader.h:25-309): one thread per (pixel, sample) path, a per-ray bounce
loop, and the scene read as uniforms.  One program owns ``block``
consecutive pixels of a film band (a ray or two per thread) and runs the
whole pipeline without touching device memory in between:

  * per-(pixel, sample) hash RNG and camera-ray generation;
  * the spp loop and the bounce loop, as real loops (``lax.fori_loop``), so
    the program size does not grow with depth or triangle count;
  * dense intersection against every triangle: a ``fori_loop`` over
    triangles reads each triangle row as scalars (the same address in every
    thread, served by the L1/constant caches — the analog of the
    reference's uniform arrays, shader.h:76-79) and keeps only the nearest
    ``(t, triangle id)`` per ray;
  * shading constants gathered once per bounce by the winning triangle id
    from the (T, 12) shade table of ops/trace.py;
  * about 20 floats of per-ray state live in registers for all
    ``depth x spp`` segments, and the film is written once per call as
    three planes (Triton blocks are powers of two, so no (..., 3) tile).

The arithmetic follows ops/trace.py and ops/intersect.py operation by
operation (same RNG streams, Möller–Trumbore intersection, sampling
formulas and termination rules), so the kernel matches ``backend="brute"``
bit for bit in interpret mode at one sample per pixel, and to rounding on
the card.

Interpret mode (``interpret=True``) runs the same kernel on the CPU through
the Pallas interpreter; it is what the CPU tests use, and is never chosen
implicitly (see policy.py).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ... import materials as mat
from ... import policy
from ...camera import Camera
from ...image import Film
from ...linalg import EPS, FLOAT_INF, SHIFT_BIAS
from ...scene import Scene
from ..trace import TABLE_COLS, shade_table

MAX_PALLAS_TRIS = policy.BRUTE_MAX  # beyond this the policy takes a BVH path
# Rays per program (a power of two) and warps per program: two rays per
# thread was the fastest of the (block, warps) pairs swept on an H100
# (PERF.md, Findings).
DEFAULT_BLOCK = 256
DEFAULT_NUM_WARPS = 4
RAYS_PER_CALL = 1 << 24  # ray paths per dispatch (pixels x spp)

# rng.py constants (must match rng.sample_seed / rng.rand01 bit for bit)
_GOLDEN = np.uint32(0x9E3779B9)
_INV_U24 = np.float32(1.0 / 16777216.0)

# Shade-table columns (ops/trace.py layout).
_ALB, _EMI, _ROUGH, _NRM, _IS_EMIT, _IS_SPEC = 0, 3, 6, 7, 10, 11


def _hash(s):
    """shader.h:81-90 xorshift/multiply mixer on uint32 arrays."""
    s = s ^ np.uint32(2747636419)
    s = s * np.uint32(2654435769)
    s = s ^ (s >> 16)
    s = s * np.uint32(2654435769)
    s = s ^ (s >> 16)
    s = s * np.uint32(2654435769)
    return s


def _rand01(s):
    """Top-24-bit uniform, the rng.rand01 contract: (s >> 8) -> int32 ->
    float32, times 2^-24."""
    s = _hash(s)
    u = (s >> 8).astype(jnp.int32).astype(jnp.float32)
    return s, u * _INV_U24


def _kernel(ip_ref, cam_ref, tri_ref, tab_ref, out_r, out_g, out_b, *,
            block: int, width: int, n_tris: int, depth: int,
            has_specular: bool, spec_tries: int):
    """One block of ``block`` pixels of a band.

    ip_ref:  (5,) int32 [sample0, seed_mix, res_y, h0, spp].  ``h0`` is the
             band's first film row: rows of a band launch are bit-identical
             to the same rows of a full-film launch, because each
             (pixel, sample) RNG stream depends only on the global (w, h).
    cam_ref: (16,) f32 [pos(3), right(3), up(3), distance*forward(3), cell,
             v_res_x/2, v_res_y/2, pixel_offset].
    tri_ref: (T, 9) [v1, e1, e2].
    tab_ref: (T, 12) shade table (ops/trace.py).
    out_*:   (block,) radiance SUM over the spp samples, one plane per
             channel.
    """
    s0 = ip_ref[0]
    seed_mix = ip_ref[1].astype(jnp.uint32)
    res_y = ip_ref[2]
    h0 = ip_ref[3]
    spp = ip_ref[4]

    pix = pl.program_id(0) * block + lax.iota(jnp.int32, block)
    w = pix % width
    h = pix // width + h0
    pix_seed = (h.astype(jnp.uint32) + w.astype(jnp.uint32)
                * res_y.astype(jnp.uint32) + np.uint32(1))
    wf = w.astype(jnp.float32)
    hf = h.astype(jnp.float32)

    px, py, pz = cam_ref[0], cam_ref[1], cam_ref[2]
    rx, ry, rz = cam_ref[3], cam_ref[4], cam_ref[5]
    ux, uy, uz = cam_ref[6], cam_ref[7], cam_ref[8]
    fx, fy, fz = cam_ref[9], cam_ref[10], cam_ref[11]
    cell, hvx, hvy, pix_off = cam_ref[12], cam_ref[13], cam_ref[14], \
        cam_ref[15]

    zeros = jnp.zeros((block,), jnp.float32)
    ones = jnp.ones((block,), jnp.float32)

    def nearest(ox, oy, oz, dx, dy, dz):
        """(best_t, best_id) over all triangles; best_id = -1 on miss."""

        def tri_body(t, carry):
            best_t, best_i = carry
            # ops/intersect.intersect_brute, term for term.  `u <= 1` is
            # implied by `v >= 0 & u + v <= 1` and dropped.
            v1x, v1y, v1z = tri_ref[t, 0], tri_ref[t, 1], tri_ref[t, 2]
            e1x, e1y, e1z = tri_ref[t, 3], tri_ref[t, 4], tri_ref[t, 5]
            e2x, e2y, e2z = tri_ref[t, 6], tri_ref[t, 7], tri_ref[t, 8]
            hx = dy * e2z - dz * e2y
            hy = dz * e2x - dx * e2z
            hz = dx * e2y - dy * e2x
            a = e1x * hx + e1y * hy + e1z * hz
            f = 1.0 / a
            sx, sy, sz = ox - v1x, oy - v1y, oz - v1z
            u = f * (sx * hx + sy * hy + sz * hz)
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            v = f * (dx * qx + dy * qy + dz * qz)
            tt = f * (e2x * qx + e2y * qy + e2z * qz)
            ok = ((jnp.abs(a) >= EPS) & (u >= 0.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (tt > 0.0) & (tt < best_t))
            return (jnp.where(ok, tt, best_t),
                    jnp.where(ok, jnp.full((block,), t, jnp.int32), best_i))

        return lax.fori_loop(
            0, n_tris, tri_body,
            (jnp.full((block,), FLOAT_INF, jnp.float32),
             jnp.full((block,), -1, jnp.int32)))

    def one_bounce(_, carry):
        (ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb, alive,
         seed) = carry
        best_t, best_i = nearest(ox, oy, oz, dx, dy, dz)
        hit = (best_i >= 0) & alive
        row = jnp.maximum(best_i, 0)

        def col(c):
            # per-ray gather of one shade-table column; misses read row 0
            # and are masked by `hit` below (ops/trace.gather_features)
            return jnp.where(hit, tab_ref[row, c], 0.0)

        alb = [col(_ALB + i) for i in range(3)]
        emi = [col(_EMI + i) for i in range(3)]
        rough = col(_ROUGH)
        ngx, ngy, ngz = (col(_NRM + i) for i in range(3))
        is_emit = col(_IS_EMIT) > 0.5
        is_spec = col(_IS_SPEC) > 0.5

        rr = rr + jnp.where(hit, tr * emi[0], 0.0)
        rg = rg + jnp.where(hit, tg * emi[1], 0.0)
        rb = rb + jnp.where(hit, tb * emi[2], 0.0)
        cont = hit & ~is_emit

        # double-sided normal, flipped toward the incoming ray (triangle.h:48)
        front = (ngx * dx + ngy * dy + ngz * dz) < 0.0
        nx = jnp.where(front, ngx, -ngx)
        ny = jnp.where(front, ngy, -ngy)
        nz = jnp.where(front, ngz, -ngz)

        # diffuse: materials.hemisphere_sample
        seed, u1 = _rand01(seed)
        seed, u2 = _rand01(seed)
        xx = 2.0 * u1 - 1.0
        ct = jnp.sqrt(jnp.maximum(1.0 - xx * xx, 0.0))
        phi = np.float32(2.0 * np.pi) * u2
        sdx, sdy, sdz = ct * jnp.cos(phi), ct * jnp.sin(phi), -xx
        sflip = jnp.where(sdx * nx + sdy * ny + sdz * nz < 0.0, -1.0, 1.0)
        ndx, ndy, ndz = sdx * sflip, sdy * sflip, sdz * sflip

        if has_specular:
            # materials.specular_sample: mirror plus the FIRST acceptable
            # of spec_tries cube jitters, else the pure mirror
            ddn = 2.0 * (dx * nx + dy * ny + dz * nz)
            mx, my, mz = dx - nx * ddn, dy - ny * ddn, dz - nz * ddn

            def try_body(_, st):
                seed, cx, cy, cz, found = st
                seed, c1 = _rand01(seed)
                seed, c2 = _rand01(seed)
                seed, c3 = _rand01(seed)
                jx = mx + (c1 - 0.5) * rough
                jy = my + (c2 - 0.5) * rough
                jz = mz + (c3 - 0.5) * rough
                take = ((jx * nx + jy * ny + jz * nz) >= 0.0) & ~found
                return (seed, jnp.where(take, jx, cx),
                        jnp.where(take, jy, cy), jnp.where(take, jz, cz),
                        found | take)

            seed, cx, cy, cz, _ = lax.fori_loop(
                0, spec_tries, try_body,
                (seed, mx, my, mz, jnp.zeros((block,), jnp.bool_)))
            norm = jnp.sqrt(cx * cx + cy * cy + cz * cz)
            ndx = jnp.where(is_spec, cx / norm, ndx)
            ndy = jnp.where(is_spec, cy / norm, ndy)
            ndz = jnp.where(is_spec, cz / norm, ndz)

        cos = nx * ndx + ny * ndy + nz * ndz
        tr = tr * jnp.where(cont, 2.0 * alb[0] * cos, 1.0)
        tg = tg * jnp.where(cont, 2.0 * alb[1] * cos, 1.0)
        tb = tb * jnp.where(cont, 2.0 * alb[2] * cos, 1.0)

        bias = np.float32(SHIFT_BIAS)
        ox = jnp.where(cont, (ox + dx * best_t) + nx * bias, ox)
        oy = jnp.where(cont, (oy + dy * best_t) + ny * bias, oy)
        oz = jnp.where(cont, (oz + dz * best_t) + nz * bias, oz)
        dx = jnp.where(cont, ndx, dx)
        dy = jnp.where(cont, ndy, dy)
        dz = jnp.where(cont, ndz, dz)
        return (ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb, cont, seed)

    def one_sample(s, acc):
        sidx = (s0 + s).astype(jnp.uint32)
        seed = _hash(pix_seed ^ (sidx * _GOLDEN))
        seed = _hash(seed ^ seed_mix)
        seed, u1 = _rand01(seed)
        seed, u2 = _rand01(seed)
        # camera.get_rays
        x = (wf + pix_off + u1) * cell - hvx
        y = (hf + pix_off + u2) * cell - hvy
        dx = x * rx + y * ux + fx
        dy = x * ry + y * uy + fy
        dz = x * rz + y * uz + fz
        norm = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        carry = (zeros + px, zeros + py, zeros + pz,
                 dx / norm, dy / norm, dz / norm, ones, ones, ones,
                 zeros, zeros, zeros, jnp.ones((block,), jnp.bool_), seed)
        carry = lax.fori_loop(0, depth, one_bounce, carry)
        return acc[0] + carry[9], acc[1] + carry[10], acc[2] + carry[11]

    acc_r, acc_g, acc_b = lax.fori_loop(0, spp, one_sample,
                                         (zeros, zeros, zeros))
    out_r[...] = acc_r
    out_g[...] = acc_g
    out_b[...] = acc_b


@functools.partial(
    jax.jit,
    static_argnames=("width", "band_h", "n_tris", "depth", "has_specular",
                     "block", "num_warps", "interpret"),
)
def _launch(iparams, cam_params, tri_params, table, *, width, band_h,
            n_tris, depth, has_specular, block, num_warps, interpret):
    """Radiance SUM of a ``band_h x width`` band as (band_h, width, 3)."""
    n_pix = width * band_h
    n_blocks = -(-n_pix // block)
    kern = functools.partial(
        _kernel, block=block, width=width, n_tris=n_tris, depth=depth,
        has_specular=has_specular, spec_tries=mat.SPECULAR_TRIES)
    plane = jax.ShapeDtypeStruct((n_blocks * block,), jnp.float32)
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    out_spec = pl.BlockSpec((block,), lambda i: (i,))
    planes = pl.pallas_call(
        kern,
        grid=(n_blocks,),
        in_specs=[any_spec] * 4,
        out_specs=[out_spec] * 3,
        out_shape=[plane] * 3,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        interpret=interpret,
        name="pathtrace_megakernel",
    )(iparams, cam_params, tri_params, table)
    # pixels past n_pix (the ragged last block) are traced and dropped
    film = jnp.stack([p[:n_pix] for p in planes], axis=-1)
    return film.reshape(band_h, width, 3)


def _camera_params(cam: Camera) -> np.ndarray:
    p = np.zeros(16, np.float32)
    p[0:3] = np.asarray(cam.pos)
    p[3:6] = np.asarray(cam.right)
    p[6:9] = np.asarray(cam.up)
    p[9:12] = np.asarray(cam.forward) * np.float32(cam.distance)
    p[12] = float(cam.cell_size)
    p[13] = float(cam.v_res[0]) * 0.5
    p[14] = float(cam.v_res[1]) * 0.5
    p[15] = float(cam.pixel_offset)
    return p


def _triangle_params(scene: Scene) -> jnp.ndarray:
    """(T, 9) = [v1, edge1, edge2] for the REAL triangles (the loop runs
    over num_tris, so padding rows are dropped)."""
    n = scene.num_tris
    v1 = scene.v1[:n]
    return jnp.concatenate(
        [v1, scene.v2[:n] - v1, scene.v3[:n] - v1], axis=-1)


def _seed_mix(seed: int) -> int:
    """rng.sample_seed's mix constant as an int32 bit pattern (the kernel
    reinterprets it as uint32)."""
    mix = (int(seed) * 0x85EBCA6B) & 0xFFFFFFFF
    return mix - (1 << 32) if mix >= (1 << 31) else mix


class PackedScene:
    """Host-side packing of (camera, scene) for the kernel, done once per
    render and reused by every launch."""

    def __init__(self, camera: Camera, scene: Scene):
        if scene.num_tris > MAX_PALLAS_TRIS:
            raise ValueError(
                f"the megakernel supports <= {MAX_PALLAS_TRIS} triangles "
                f"(got {scene.num_tris}); use a BVH backend")
        self.n_tris = scene.num_tris
        self.has_specular = scene.has_specular
        self.cam = jnp.asarray(_camera_params(camera))
        self.tri = _triangle_params(scene)
        self.table = shade_table(scene)[: scene.num_tris]
        assert self.table.shape[1] == TABLE_COLS

    def launch(self, iparams, *, width, band_h, depth, interpret,
               block=DEFAULT_BLOCK, num_warps=DEFAULT_NUM_WARPS):
        return _launch(iparams, self.cam, self.tri, self.table,
                       width=width, band_h=band_h, n_tris=self.n_tris,
                       depth=depth, has_specular=self.has_specular,
                       block=block, num_warps=num_warps,
                       interpret=interpret)


def render_sum_pallas(camera: Camera, scene: Scene, sample0: int,
                      samples: int, depth: int = 5, *, seed: int = 1,
                      interpret: bool, block: int = DEFAULT_BLOCK,
                      num_warps: int = DEFAULT_NUM_WARPS,
                      spp_per_call: Optional[int] = None,
                      verbose: bool = False) -> jnp.ndarray:
    """Radiance SUM over samples [sample0, sample0+samples) as an
    (H, W, 3) array.  Because each (pixel, sample) pair owns an
    independent RNG stream, sample windows compose exactly: summing two
    adjacent windows equals one combined render — the property the
    block-boundary checkpointing in render.py relies on."""
    policy.check_kernel_platform(interpret)
    if block <= 0 or block & (block - 1):
        raise ValueError(f"block must be a power of two (got {block})")
    packed = PackedScene(camera, scene)
    width, height = camera.res
    if spp_per_call is None:
        spp_per_call = max(1, min(samples, RAYS_PER_CALL // (width * height)))
    mix = _seed_mix(seed)

    film = jnp.zeros((height, width, 3), jnp.float32)
    s = 0
    while s < samples:
        spp = min(spp_per_call, samples - s)
        iparams = jnp.array([sample0 + s, mix, height, 0, spp], jnp.int32)
        film = film + packed.launch(
            iparams, width=width, band_h=height, depth=depth,
            interpret=interpret, block=block, num_warps=num_warps)
        s += spp
        if verbose:
            print(f"\rRendered: {sample0 + s} spp.", end="", flush=True)
    if verbose:
        print()
    return film


def render_film_pallas(camera: Camera, scene: Scene, samples: int,
                       depth: int = 5, *, seed: int = 1, interpret: bool,
                       block: int = DEFAULT_BLOCK,
                       num_warps: int = DEFAULT_NUM_WARPS,
                       spp_per_call: Optional[int] = None,
                       verbose: bool = False) -> Film:
    """Render the sample-averaged linear film with the megakernel."""
    film = render_sum_pallas(
        camera, scene, 0, samples, depth, seed=seed, interpret=interpret,
        block=block, num_warps=num_warps, spp_per_call=spp_per_call,
        verbose=verbose)
    film = film / np.float32(samples)
    return Film(camera.res, data=film.block_until_ready())
