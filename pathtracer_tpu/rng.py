"""Random number generation (L1).

Two RNG disciplines, mirroring the reference:

1. ``Lcg`` — the host-side linear congruential generator matching
   ``/root/reference/pathtracer/rng.h:6-32`` bit for bit (a=1664525,
   c=1013904223, m=2^32).  The reference holds ONE global instance shared by
   camera jitter and BRDF sampling, which makes samples sequentially coupled;
   we keep it only for host-side/oracle parity and testing.

2. ``hash_u32`` / ``rand01`` — the counter-free per-pixel hash stream used by
   the reference GPU megakernel (``shader.h:81-90``): an xorshift/multiply
   mixer advanced in place.  This is the parallel-friendly discipline (each
   pixel owns an independent u32 state seeded from its coordinates,
   ``shader.h:283-287``) and is what the device pipeline uses.  All ops
   are uint32 elementwise, fully vectorized over ray batches.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

SEED = 1  # rng.h:3


class Lcg:
    """Bit-exact port of the reference LCG (rng.h:6-32). Host-side only."""

    A = np.uint64(1664525)
    C = np.uint64(1013904223)
    M = np.uint64(4294967296)

    def __init__(self, seed: int = SEED):
        self.state = np.uint64(seed)

    def next_u32(self) -> int:
        self.state = (self.A * self.state + self.C) % self.M
        return int(self.state)

    def rand01(self) -> float:
        return float(np.float32(self.next_u32()) / np.float32(self.M))

    def seed(self, seed: int) -> None:
        self.state = np.uint64(seed)


def hash_u32(state):
    """One step of the GPU hash RNG (shader.h:81-90). uint32 array in/out."""
    state = jnp.asarray(state, jnp.uint32)
    state = state ^ jnp.uint32(2747636419)
    state = state * jnp.uint32(2654435769)
    state = state ^ (state >> 16)
    state = state * jnp.uint32(2654435769)
    state = state ^ (state >> 16)
    state = state * jnp.uint32(2654435769)
    return state


def rand01(state):
    """Advance the hash state and return (new_state, uniform in [0, 1)).

    The reference computes float(state)/4294967295 (shader.h:89); float32
    only resolves ~24 bits of that anyway, so we use the top 24 bits
    directly: u = (state >> 8) / 2^24.  Statistically identical, and the
    uint32 -> int32 -> float32 conversion chain is part of the contract with
    the Pallas megakernel, which computes the same chain and so stays
    bit-identical to this path.
    """
    state = hash_u32(state)
    u = (state >> 8).astype(jnp.int32).astype(jnp.float32)
    return state, u * jnp.float32(1.0 / 16777216.0)


def randn01(state, n: int):
    """Draw ``n`` uniforms per lane; returns (state, u) with u shape (n, *state.shape)."""
    us = []
    for _ in range(n):
        state, u = rand01(state)
        us.append(u)
    return state, jnp.stack(us, axis=0)


def pixel_seed(w, h, res_y, frame=None):
    """Per-pixel seed discipline of the reference megakernel (shader.h:283-287).

    Offline:  seed = uint(gl_FragCoord.y + gl_FragCoord.x * res.y + 1)
    Realtime: seed = uint(frame * gl_FragCoord.y + gl_FragCoord.x * res.y + 1)

    gl_FragCoord carries the half-pixel offset (w+0.5, h+0.5); we reproduce
    the float-then-truncate behaviour exactly.
    """
    fx = w.astype(jnp.float32) + 0.5
    fy = h.astype(jnp.float32) + 0.5
    if frame is None:
        val = fy + fx * jnp.float32(res_y) + 1.0
    else:
        val = jnp.float32(frame) * fy + fx * jnp.float32(res_y) + 1.0
    return val.astype(jnp.uint32)


def sample_seed(w, h, res_y, sample_idx, base_seed: int = SEED):
    """Device sampling discipline: a distinct, decorrelated u32 stream per
    (pixel, sample) pair so sample batches are order-independent and
    shardable.  We fold pixel index, sample index and the global seed
    through one hash round to decorrelate neighbouring streams.

    This intentionally diverges from the reference GPU's sequential
    per-pixel stream (one stream reused across its in-shader spp loop):
    independent per-sample streams are what make sample-axis sharding
    reassociable (SURVEY.md §5 "long-context" analog).
    """
    pix = (h.astype(jnp.uint32) + w.astype(jnp.uint32) * jnp.uint32(res_y) + jnp.uint32(1))
    s = hash_u32(pix ^ (jnp.uint32(sample_idx) * jnp.uint32(0x9E3779B9)))
    mix = (int(base_seed) * 0x85EBCA6B) & 0xFFFFFFFF
    return hash_u32(s ^ jnp.uint32(mix))
