"""ORB features from scratch, batched on device: oriented-FAST angle by
intensity centroid, 256-bit rotated BRIEF, Hamming brute-force matching.

Re-derivation in JAX of the reference's hand-written ORB
(reference: 05-frontend-feature-matching/01-orb-feature-matching/
compute_orb.cpp:22-46 computeAngle via intensity centroid over a 16x16
patch, :48-... rBRIEF from the 256-pair pattern, brute-force Hamming
match with a distance gate).  Descriptors are bit-packed into 8 uint32
lanes; Hamming distance is popcount over XOR, giving an (N1, N2) distance
matrix as dense integer ops on the device.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from . import pyramid

HALF_PATCH = 8          # intensity-centroid radius (reference: 16x16 patch)


def _brief_pattern(n_pairs: int = 256, radius: float = 13.0, seed: int = 7):
    """The fixed BRIEF sampling pattern: n_pairs of (p, q) offsets.  The
    reference hardcodes the 256-pair ORB pattern array; an isotropic
    Gaussian pattern has the same statistics and stays self-contained."""
    rng = np.random.default_rng(seed)
    pts = np.clip(rng.normal(0.0, radius / 2.0, (n_pairs, 4)),
                  -radius, radius)
    return jnp.asarray(pts, jnp.float32)   # (256, 4) = (px, py, qx, qy)


_PATTERN = _brief_pattern()


def orientation(img, xy):
    """Intensity-centroid angle at keypoints xy (N, 2) → (N,) radians
    (computeAngle, compute_orb.cpp:22-46)."""
    d = jnp.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=img.dtype)
    dx, dy = jnp.meshgrid(d, d)
    offs = jnp.stack([dx, dy], axis=-1).reshape(-1, 2)     # (P², 2)
    patches = pyramid.bilinear_sample(img, xy[:, None, :] + offs[None])
    m10 = jnp.sum(patches * offs[None, :, 0], axis=1)
    m01 = jnp.sum(patches * offs[None, :, 1], axis=1)
    return jnp.arctan2(m01, m10)


@partial(jax.jit)
def describe(img, xy, valid):
    """256-bit rBRIEF descriptors, packed (N, 8) uint32.
    Pattern points are rotated by the keypoint orientation before
    sampling (compute_orb.cpp rBRIEF)."""
    theta = orientation(img, xy)
    c, s = jnp.cos(theta), jnp.sin(theta)                  # (N,)
    pat = _PATTERN.astype(img.dtype)                       # (256, 4)

    def rot(ox, oy):
        # (N, 256) rotated offsets
        return (c[:, None] * ox[None, :] - s[:, None] * oy[None, :],
                s[:, None] * ox[None, :] + c[:, None] * oy[None, :])

    pxr, pyr = rot(pat[:, 0], pat[:, 1])
    qxr, qyr = rot(pat[:, 2], pat[:, 3])
    p_pos = xy[:, None, :] + jnp.stack([pxr, pyr], axis=-1)
    q_pos = xy[:, None, :] + jnp.stack([qxr, qyr], axis=-1)
    bits = (pyramid.bilinear_sample(img, p_pos) <
            pyramid.bilinear_sample(img, q_pos))           # (N, 256)
    bits = bits & valid[:, None]
    lanes = bits.reshape(bits.shape[0], 8, 32).astype(jnp.uint32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    # sum promotes to uint64 under x64 — force the packed lanes back to
    # uint32 (the popcount below relies on 32-bit wraparound)
    return jnp.sum(lanes * weights[None, None, :],
                   axis=-1).astype(jnp.uint32)  # (N, 8) uint32


def _popcount32(x):
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (x * jnp.uint32(0x01010101)) >> 24


@jax.jit
def hamming_matrix(d1, d2):
    """(N1, N2) Hamming distances between packed descriptor sets."""
    # the multiply-shift popcount needs true 32-bit wraparound; inputs
    # arriving as uint64 (x64 sum promotion) would silently corrupt it
    d1 = d1.astype(jnp.uint32)
    d2 = d2.astype(jnp.uint32)
    x = d1[:, None, :] ^ d2[None, :, :]                    # (N1, N2, 8)
    return jnp.sum(_popcount32(x), axis=-1).astype(jnp.int32)


@jax.jit
def match(d1, d2, valid1, valid2, max_dist: int = 40):
    """Brute-force Hamming matching with a distance gate (the reference
    gates at d < 0.4·256 ≈ 102; ORB convention uses ≤ 40-64 for strong
    matches).  Returns (idx2 (N1,), dist (N1,), ok (N1,))."""
    D = hamming_matrix(d1, d2)
    D = jnp.where(valid2[None, :], D, 512)
    idx = jnp.argmin(D, axis=1)
    dist = jnp.take_along_axis(D, idx[:, None], axis=1)[:, 0]
    ok = valid1 & (dist <= max_dist)
    return idx, dist, ok
