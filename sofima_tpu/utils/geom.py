"""Integral images (summed-area tables) and patch occupancy queries.

JAX equivalents of the `connectomics.common.geom_utils` helpers the
reference uses for mask-based patch selection
(/root/reference/flow_field.py:159-175, 575-589).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np


def integral_image_np(mask: np.ndarray) -> np.ndarray:
  """Summed-area table with a zero border, computed with NumPy (int64)."""
  ii = mask.astype(np.int64)
  for axis in range(mask.ndim):
    ii = ii.cumsum(axis=axis)
  pads = [(1, 0)] * mask.ndim
  return np.pad(ii, pads, mode='constant')


@jax.jit
def _integral_image_jax(mask: jnp.ndarray) -> jnp.ndarray:
  ii = mask.astype(jnp.uint32)
  for axis in range(mask.ndim):
    ii = ii.cumsum(axis=axis)
  pads = [(1, 0)] * mask.ndim
  return jnp.pad(ii, pads, mode='constant')


def integral_image(mask) -> np.ndarray | jnp.ndarray | None:
  """Summed-area table of a boolean/integer mask.

  Uses an on-device uint32 cumsum for small arrays and falls back to int64
  NumPy when the sum could overflow 32 bits.
  """
  if mask is None:
    return None
  if mask.size >= 2**32:
    return integral_image_np(np.asarray(mask))
  return _integral_image_jax(jnp.asarray(mask))


def query_integral_image(
    ii: np.ndarray | jnp.ndarray,
    patch_size: Sequence[int],
    stride: Sequence[int],
) -> np.ndarray:
  """Sums within all patches of `patch_size` sampled at `stride` spacing.

  Args:
    ii: integral image as returned by `integral_image` ([d0+1, d1+1, ...])
    patch_size: per-axis patch extents
    stride: per-axis patch start spacing

  Returns:
    array of per-patch sums with shape `(dims - patch_size) // stride + 1`
  """
  ii = np.asarray(ii)
  if ii.dtype == np.uint32:
    ii = ii.astype(np.int64)
  dim = ii.ndim
  patch = np.asarray(patch_size)
  step = np.asarray(stride)
  dims = np.array(ii.shape) - 1
  out_shape = (dims - patch) // step + 1
  if np.any(out_shape <= 0):
    raise ValueError(f'patch {patch} too large for image {dims}')

  # Inclusion-exclusion over the 2^dim corners of each patch.
  result = np.zeros(out_shape, dtype=ii.dtype)
  starts = [np.arange(n) * s for n, s in zip(out_shape, step)]
  grids = np.meshgrid(*starts, indexing='ij')
  for corner in range(2**dim):
    idx = []
    sign = 1
    for axis in range(dim):
      if corner & (1 << axis):
        idx.append(grids[axis] + patch[axis])
      else:
        idx.append(grids[axis])
        sign = -sign
    # Parity of the number of "low" corners sets the sign; all-high is +.
    result = result + sign * ii[tuple(idx)]
  return result
