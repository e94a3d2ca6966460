"""Ray-scene intersection ops (replaces bvh.h:156-183 / shader.h:92-193).

Two traversal strategies, selected by scene size:

* ``intersect_brute`` — dense rays x triangles Möller–Trumbore.  Testing
  EVERY triangle against every ray in one fused broadcast expression is
  faster than divergent tree traversal up to a few hundred triangles, and
  all the headline scenes (3-32 triangles) are far below that.  This is the
  intersection arithmetic the Pallas megakernel uses too.  There is no
  per-ray control flow at all: invalid candidates are masked to FLOAT_INF
  and the nearest hit is a plain min-reduction over the triangle axis.

* ``intersect_bvh`` — vectorized stack-based traversal over the flat BVH node
  arrays (same pointer-free data format as the reference GPU consumes,
  shader.h:76-79/153-193) for OBJ-scale scenes.  Every ray carries a fixed
  -size stack; one ``lax.while_loop`` steps all rays together until every
  stack is empty.  Leaf ranges are processed with a fixed-width masked loop
  (the builder bounds leaf size), keeping all shapes static for XLA.

Both return ``(t, tid)`` with ``t = FLOAT_INF`` and ``tid = -1`` on miss,
matching the reference contract (bvh.h:156-183).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..linalg import EPS, FLOAT_INF, cross, dot


def intersect_brute(ray_o, ray_d, v1, v2, v3):
    """Dense Möller–Trumbore (triangle.h:25-44) over all triangles.

    ray_o, ray_d: (..., 3); v1, v2, v3: (T, 3).
    Returns (t, tid): t (...,) nearest positive hit or FLOAT_INF; tid (...,)
    int32 triangle index or -1.  Degenerate (padding) triangles are rejected
    by the |det| < EPS test.
    """
    e1 = v2 - v1                       # (T, 3)
    e2 = v3 - v1
    d = ray_d[..., None, :]            # (..., 1, 3)
    o = ray_o[..., None, :]

    h = cross(d, e2)                   # (..., T, 3)
    a = dot(e1, h)                     # (..., T)
    f = 1.0 / a                        # inf/nan where degenerate; masked below
    s = o - v1
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(d, q)
    t = f * dot(e2, q)

    valid = (
        (jnp.abs(a) >= EPS)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > 0.0)
    )
    t = jnp.where(valid, t, FLOAT_INF)
    tid = jnp.argmin(t, axis=-1).astype(jnp.int32)
    tmin = jnp.min(t, axis=-1)
    tid = jnp.where(tmin < FLOAT_INF, tid, -1)
    return tmin, tid


def intersect_one_triangle(ray_o, ray_d, v1, v2, v3):
    """Möller–Trumbore of a ray batch against ONE triangle per ray.

    All inputs (..., 3) — used by the BVH leaf loop where vertices are
    gathered per ray.  Returns (t, valid)."""
    e1 = v2 - v1
    e2 = v3 - v1
    h = cross(ray_d, e2)
    a = dot(e1, h)
    f = 1.0 / a
    s = ray_o - v1
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(ray_d, q)
    t = f * dot(e2, q)
    valid = (
        (jnp.abs(a) >= EPS)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > 0.0)
    )
    return jnp.where(valid, t, FLOAT_INF), valid


def aabb_hit(ray_o, inv_ray_d, lb, rt):
    """Slab test (aabb.h:20-29): hit iff tmin <= tmax and tmax >= 0."""
    t1 = (lb - ray_o) * inv_ray_d
    t2 = (rt - ray_o) * inv_ray_d
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    return (tmax >= 0.0) & (tmin <= tmax)


def intersect_bvh(ray_o, ray_d, flat, v1, v2, v3, max_leaf: int,
                  stack_size: int):
    """Vectorized stack traversal of the flat BVH (bvh.h:156-183).

    ray_o, ray_d: (R, 3) — flat ray batch.
    flat: a ``bvh.FlatBVH`` pytree of node arrays (lb/rt (M,3), left/right/
    tri_start/tri_end (M,), tri_idx (T,)).
    max_leaf: static bound on leaf triangle count (enforced by the builder).
    stack_size: static per-ray stack capacity (>= BVH depth + 1).

    All rays step the while-loop together; rays whose stack is empty are
    masked out.  Total iterations = the maximum node-visit count over the
    batch — the structural analog of SIMT divergence on the GPU.
    """
    R = ray_o.shape[0]
    inv_d = 1.0 / ray_d

    stack = jnp.zeros((R, stack_size), jnp.int32)  # root (=0) pre-seeded
    sp = jnp.ones((R,), jnp.int32)                 # stack pointer
    best_t = jnp.full((R,), FLOAT_INF, jnp.float32)
    best_tid = jnp.full((R,), -1, jnp.int32)

    def cond(state):
        _, sp, _, _ = state
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, best_t, best_tid = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = jnp.take_along_axis(stack, top[:, None], axis=1)[:, 0]
        node = jnp.where(active, node, 0)
        sp = jnp.where(active, sp - 1, sp)

        lb = flat.lb[node]
        rt = flat.rt[node]
        hit_box = aabb_hit(ray_o, inv_d, lb, rt) & active

        left = flat.left[node]
        right = flat.right[node]
        tri_start = flat.tri_start[node]
        tri_end = flat.tri_end[node]
        is_leaf = left == -1

        # --- leaf: masked fixed-width loop over the leaf range -------------
        do_leaf = hit_box & is_leaf
        for k in range(max_leaf):
            slot = tri_start + k
            in_range = do_leaf & (slot <= tri_end)
            slot = jnp.where(in_range, slot, 0)
            tri = flat.tri_idx[slot]
            t, valid = intersect_one_triangle(
                ray_o, ray_d, v1[tri], v2[tri], v3[tri]
            )
            better = in_range & valid & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            best_tid = jnp.where(better, tri, best_tid)

        # --- internal: push both children ----------------------------------
        push = hit_box & ~is_leaf
        stack = _masked_push(stack, sp, left, push)
        sp = sp + push.astype(jnp.int32)
        stack = _masked_push(stack, sp, right, push)
        sp = sp + push.astype(jnp.int32)

        return stack, sp, best_t, best_tid

    _, _, best_t, best_tid = lax.while_loop(
        cond, body, (stack, sp, best_t, best_tid)
    )
    return best_t, best_tid


def _masked_push(stack, sp, value, mask):
    """stack[r, sp[r]] = value[r] where mask[r]; stack (R, S)."""
    S = stack.shape[1]
    col = jax.lax.broadcasted_iota(jnp.int32, stack.shape, 1)
    at = col == jnp.minimum(sp, S - 1)[:, None]
    return jnp.where(at & mask[:, None], value[:, None], stack)


def intersect_bvh_packet(ray_o, ray_d, flat, v1, v2, v3, max_leaf: int,
                         stack_size: int, packet_rays: int = 8192):
    """Packet traversal of the flat BVH.

    ``intersect_bvh`` gives every ray its own stack, which makes every node
    fetch, stack access and leaf-vertex load a gather with per-ray indices.
    This variant restructures the traversal so that a whole PACKET of rays
    shares ONE scalar traversal stack (the classic coherent packet
    traversal, re-derived for a vector machine):

      * the node index is a traced SCALAR -> node boxes / children / leaf
        ranges / triangle vertices are scalar ``dynamic_slice`` loads, never
        gathers;
      * the AABB slab test and Möller–Trumbore run densely over the packet
        (elementwise ops), with per-ray nearest-hit masking (the slab entry
        distance must beat the ray's current best t);
      * a subtree is descended iff ANY ray in the packet wants it (an
        ``any`` reduction — the vector analog of SIMT ballot);
      * leaf work is guarded by a real scalar ``lax.cond`` so interior
        visits do not pay the triangle-test cost (per-ray traversal cannot
        branch like this — its leaf mask differs per lane).

    Rays are processed in packets of ``packet_rays`` via ``lax.map``: camera
    tiles arrive in pixel order, so packets inherit spatial coherence.
    Same (t, tid) contract as ``intersect_bvh``; the hit set is identical
    (both enumerate the same leaves; nearest-hit reduction is order
    -independent for distinct t).

    Reference analog: bvh.h:156-183 / shader.h:153-193 (per-thread stacks on
    a SIMT machine); this is the data-parallel re-architecture, not a
    translation.
    """
    R = ray_o.shape[0]
    pr = min(packet_rays, R)
    if R % pr:  # fall back to one packet (callers pass 2^k sizes)
        pr = R
    n_pk = R // pr

    def one_packet(rays):
        p_o, p_d = rays
        inv_d = 1.0 / p_d

        stack0 = jnp.zeros((stack_size,), jnp.int32)  # root (=0) pre-seeded
        state0 = (stack0, jnp.int32(1),
                  jnp.full((pr,), FLOAT_INF, jnp.float32),
                  jnp.full((pr,), -1, jnp.int32))

        def cond(state):
            return state[1] > 0

        def body(state):
            stack, sp, best_t, best_tid = state
            node = lax.dynamic_index_in_dim(stack, sp - 1, keepdims=False)
            sp = sp - 1

            lb = lax.dynamic_index_in_dim(flat.lb, node, keepdims=False)
            rt = lax.dynamic_index_in_dim(flat.rt, node, keepdims=False)
            t1 = (lb - p_o) * inv_d
            t2 = (rt - p_o) * inv_d
            tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
            tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
            # slab hit AND the box entry can still beat this ray's best hit
            hit = (tmax >= 0.0) & (tmin <= tmax) & (tmin < best_t)

            left = lax.dynamic_index_in_dim(flat.left, node, keepdims=False)
            right = lax.dynamic_index_in_dim(flat.right, node,
                                             keepdims=False)
            tri_start = lax.dynamic_index_in_dim(flat.tri_start, node,
                                                 keepdims=False)
            tri_end = lax.dynamic_index_in_dim(flat.tri_end, node,
                                               keepdims=False)
            any_hit = jnp.any(hit)
            is_leaf = left == -1

            def do_leaf(op):
                best_t, best_tid = op

                def tri_body(k, carry):
                    best_t, best_tid = carry
                    slot = jnp.minimum(tri_start + k, tri_end)
                    tri = lax.dynamic_index_in_dim(flat.tri_idx, slot,
                                                   keepdims=False)
                    a1 = lax.dynamic_index_in_dim(v1, tri, keepdims=False)
                    a2 = lax.dynamic_index_in_dim(v2, tri, keepdims=False)
                    a3 = lax.dynamic_index_in_dim(v3, tri, keepdims=False)
                    t, valid = intersect_one_triangle(p_o, p_d, a1, a2, a3)
                    better = hit & valid & (t < best_t)
                    return (jnp.where(better, t, best_t),
                            jnp.where(better, tri, best_tid))

                n_leaf = jnp.minimum(tri_end - tri_start + 1, max_leaf)
                return lax.fori_loop(0, n_leaf, tri_body, (best_t, best_tid))

            best_t, best_tid = lax.cond(
                any_hit & is_leaf, do_leaf, lambda op: op,
                (best_t, best_tid))

            # interior & visited: push both children (shared scalar stack)
            def push(op):
                stack, sp = op
                stack = lax.dynamic_update_index_in_dim(stack, left, sp, 0)
                stack = lax.dynamic_update_index_in_dim(
                    stack, right, sp + 1, 0)
                return stack, sp + 2

            stack, sp = lax.cond(any_hit & ~is_leaf, push, lambda op: op,
                                 (stack, sp))
            return stack, sp, best_t, best_tid

        _, _, best_t, best_tid = lax.while_loop(cond, body, state0)
        return best_t, best_tid

    if n_pk == 1:
        return one_packet((ray_o, ray_d))
    t, tid = lax.map(one_packet, (ray_o.reshape(n_pk, pr, 3),
                                  ray_d.reshape(n_pk, pr, 3)))
    return t.reshape(R), tid.reshape(R)
