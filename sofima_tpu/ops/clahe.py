"""Contrast-limited adaptive histogram equalization (CLAHE) on device.

JAX replacement for skimage.exposure.equalize_adapthist as used in
tile rendering (/root/reference/warp.py:457-461). Classic CLAHE: per-tile
clipped histograms -> CDFs, bilinear interpolation of tile mappings at
every pixel. Histograms are built with one-hot bincounts (VPU-friendly),
the per-pixel mapping lookup is a gather into the tile CDF table.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=['grid', 'nbins', 'clip_limit'])
def clahe(image: jnp.ndarray, grid: tuple[int, int] = (8, 8),
          clip_limit: float = 0.01, nbins: int = 256) -> jnp.ndarray:
  """Equalizes a [y, x] image in [0, 1]; returns float32 in [0, 1].

  Args:
    image: [y, x] float image scaled to [0, 1]
    grid: number of context tiles (rows, cols)
    clip_limit: histogram clip limit as a fraction of tile pixel count
    nbins: histogram bins
  """
  h, w = image.shape
  gy, gx = grid
  th, tw = -(-h // gy), -(-w // gx)
  pad_h, pad_w = th * gy - h, tw * gx - w
  img = jnp.pad(image, ((0, pad_h), (0, pad_w)), mode='edge')

  # [gy, gx, th, tw] tiles.
  tiles = img.reshape(gy, th, gx, tw).transpose(0, 2, 1, 3)
  bins = jnp.clip((tiles * (nbins - 1)).astype(jnp.int32), 0, nbins - 1)

  # Per-tile histogram via one-hot accumulation.
  one_hot = jax.nn.one_hot(bins.reshape(gy, gx, -1), nbins, dtype=jnp.float32)
  hist = one_hot.sum(axis=2)  # [gy, gx, nbins]

  # Clip and redistribute excess uniformly.
  npix = th * tw
  limit = jnp.maximum(clip_limit * npix, 1.0)
  excess = jnp.sum(jnp.maximum(hist - limit, 0.0), axis=-1, keepdims=True)
  hist = jnp.minimum(hist, limit) + excess / nbins

  cdf = jnp.cumsum(hist, axis=-1)
  cdf = cdf / cdf[..., -1:]  # [gy, gx, nbins] in (0, 1]

  # Bilinear interpolation between the 4 surrounding tile mappings.
  yy = (jnp.arange(h, dtype=jnp.float32) + 0.5) / th - 0.5
  xx = (jnp.arange(w, dtype=jnp.float32) + 0.5) / tw - 0.5
  y0 = jnp.clip(jnp.floor(yy).astype(jnp.int32), 0, gy - 2) if gy > 1 else (
      jnp.zeros(h, jnp.int32))
  x0 = jnp.clip(jnp.floor(xx).astype(jnp.int32), 0, gx - 2) if gx > 1 else (
      jnp.zeros(w, jnp.int32))
  fy = jnp.clip(yy - y0, 0.0, 1.0) if gy > 1 else jnp.zeros(h)
  fx = jnp.clip(xx - x0, 0.0, 1.0) if gx > 1 else jnp.zeros(w)

  pix_bins = jnp.clip((image * (nbins - 1)).astype(jnp.int32), 0, nbins - 1)
  y0g = y0[:, None]
  x0g = x0[None, :]
  y1g = jnp.minimum(y0g + 1, gy - 1)
  x1g = jnp.minimum(x0g + 1, gx - 1)

  def look(ty, tx):
    return cdf[ty, tx, pix_bins]

  fyg = fy[:, None]
  fxg = fx[None, :]
  out = ((1 - fyg) * (1 - fxg) * look(y0g, x0g)
         + (1 - fyg) * fxg * look(y0g, x1g)
         + fyg * (1 - fxg) * look(y1g, x0g)
         + fyg * fxg * look(y1g, x1g))
  return out.astype(jnp.float32)


def equalize_adapthist(image: np.ndarray, kernel_size=None,
                       clip_limit: float = 0.01,
                       nbins: int = 256) -> np.ndarray:
  """skimage-compatible wrapper: uint images in, float [0,1] out."""
  image = np.asarray(image)
  if np.issubdtype(image.dtype, np.integer):
    scaled = image.astype(np.float32) / np.iinfo(image.dtype).max
  else:
    scaled = image.astype(np.float32)
  h, w = scaled.shape
  if kernel_size is None:
    grid = (8, 8)
  else:
    if not isinstance(kernel_size, (tuple, list)):
      kernel_size = (kernel_size, kernel_size)
    grid = (max(1, h // int(kernel_size[0])), max(1, w // int(kernel_size[1])))
  return np.asarray(clahe(jnp.asarray(scaled), grid=grid,
                          clip_limit=clip_limit, nbins=nbins))
