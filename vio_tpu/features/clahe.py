"""Contrast-limited adaptive histogram equalization (CLAHE), on device.

Replaces cv::createCLAHE(3.0, cv::Size(8, 8)) (reference:
vins-mono/src/feature_tracker.cpp:89-91 — applied to every frame when
EQUALIZE, which the EuRoC config enables because the sequences are dark).

Device formulation: per-tile 256-bin histograms via one scatter-add,
clip + uniform excess redistribution, per-tile LUT from the cumulative
histogram, then one gather with bilinear interpolation between the four
neighboring tile LUTs per pixel.  Fixed shapes, one fused XLA program —
no per-tile host loop.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

N_BINS = 256


@partial(jax.jit, static_argnames=("grid_h", "grid_w"))
def clahe(img, clip_limit: float = 3.0, grid_h: int = 8, grid_w: int = 8):
    """Equalize a grayscale image (H, W) with values in [0, 255].

    Returns float32 in [0, 255].  The image is padded (edge mode) up to a
    multiple of the tile grid, exactly like OpenCV's border replication.
    """
    img = jnp.asarray(img, jnp.float32)
    H, W = img.shape
    th = -(-H // grid_h)      # ceil division
    tw = -(-W // grid_w)
    Hp, Wp = th * grid_h, tw * grid_w
    padded = jnp.pad(img, ((0, Hp - H), (0, Wp - W)), mode="edge")

    # --- per-tile histograms (one scatter-add over all pixels) ---
    v = jnp.clip(padded, 0.0, 255.0)
    bins = jnp.clip(v.astype(jnp.int32), 0, N_BINS - 1)
    ty = jnp.arange(Hp) // th                              # (Hp,)
    tx = jnp.arange(Wp) // tw                              # (Wp,)
    tile_id = ty[:, None] * grid_w + tx[None, :]           # (Hp, Wp)
    flat_idx = tile_id * N_BINS + bins
    hist = jnp.zeros(grid_h * grid_w * N_BINS, jnp.float32).at[
        flat_idx.reshape(-1)].add(1.0)
    hist = hist.reshape(grid_h * grid_w, N_BINS)

    # --- clip + redistribute excess uniformly (OpenCV CLAHE semantics:
    # clip value is clip_limit * tile_area / n_bins, min 1) ---
    tile_area = float(th * tw)
    clip = jnp.maximum(clip_limit * tile_area / N_BINS, 1.0)
    excess = jnp.sum(jnp.maximum(hist - clip, 0.0), axis=1, keepdims=True)
    hist = jnp.minimum(hist, clip) + excess / N_BINS

    # --- per-tile LUT: scaled CDF ---
    cdf = jnp.cumsum(hist, axis=1)
    lut = cdf * ((N_BINS - 1.0) / tile_area)               # (T, 256)
    lut = lut.reshape(grid_h, grid_w, N_BINS)

    # --- bilinear interpolation between the 4 surrounding tile LUTs ---
    fy = (jnp.arange(Hp, dtype=jnp.float32) + 0.5) / th - 0.5
    fx = (jnp.arange(Wp, dtype=jnp.float32) + 0.5) / tw - 0.5
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, grid_h - 1)
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, grid_w - 1)
    y1 = jnp.minimum(y0 + 1, grid_h - 1)
    x1 = jnp.minimum(x0 + 1, grid_w - 1)
    wy = jnp.clip(fy - y0.astype(jnp.float32), 0.0, 1.0)[:, None]
    wx = jnp.clip(fx - x0.astype(jnp.float32), 0.0, 1.0)[None, :]

    def at(yi, xi):
        return lut[yi[:, None], xi[None, :], bins]

    out = ((1 - wy) * (1 - wx) * at(y0, x0) + (1 - wy) * wx * at(y0, x1)
           + wy * (1 - wx) * at(y1, x0) + wy * wx * at(y1, x1))
    return out[:H, :W]
