"""Euclidean distance transform on device (jump flooding).

JAX replacement for the `edt` C++ library used for tile-blending
weights (/root/reference/processor/warp.py:147-161). Uses the
jump-flooding algorithm: O(log n) vectorized passes propagating
nearest-background-seed coordinates; distances are exact for all but a
vanishing fraction of pixels (JFA's known rare approximation cases),
which is inconsequential for blending weights.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sofima_tpu.ops.fill import _neighbor_offsets, _shift


@jax.jit
def _edt_jfa(inside: jnp.ndarray) -> jnp.ndarray:
  """Distance from each True pixel to the nearest False pixel (2d)."""
  h, w = inside.shape
  big = jnp.float32(1e12)
  grids = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                       jnp.arange(w, dtype=jnp.float32), indexing='ij')
  coords = jnp.stack(grids)
  # Seeds = background pixels (their own coordinates).
  seed = jnp.where(~inside[None], coords, big)

  max_side = max(h, w)
  steps = []
  s = 1
  while s < max_side:
    s *= 2
  while s >= 1:
    steps.append(s)
    s //= 2

  def d2_of(cand):
    return jnp.where(jnp.any(cand >= big, axis=0), big,
                     (cand[0] - coords[0])**2 + (cand[1] - coords[1])**2)

  for step in steps:
    best = seed
    best_d2 = d2_of(best)
    for offs in _neighbor_offsets(2, step):
      cand = _shift(seed, (0,) + offs, big)
      d2 = d2_of(cand)
      better = d2 < best_d2
      best = jnp.where(better[None], cand, best)
      best_d2 = jnp.where(better, d2, best_d2)
    seed = best

  return jnp.sqrt(d2_of(seed))


def edt(mask: np.ndarray, black_border: bool = True,
        parallel: int = 0) -> np.ndarray:
  """2d Euclidean distance transform of a boolean/integer mask.

  Uses the exact native C++ kernel (separable lower-envelope algorithm,
  sofima_tpu.native) when available, falling back to on-device jump
  flooding.

  Args:
    mask: nonzero pixels are 'inside'; distance is to the nearest zero
    black_border: treat the image border as background
    parallel: accepted for API compatibility with the `edt` package

  Returns:
    float32 distance map, 0 on background pixels
  """
  del parallel
  from sofima_tpu import native
  native_out = native.edt2d(np.asarray(mask), black_border=black_border)
  if native_out is not None:
    return native_out

  inside = np.asarray(mask) != 0
  if black_border:
    padded = np.pad(inside, 1, constant_values=False)
    out = np.asarray(_edt_jfa(jnp.asarray(padded)))[1:-1, 1:-1]
  else:
    if inside.all():
      return np.full(inside.shape, np.inf, np.float32)
    out = np.asarray(_edt_jfa(jnp.asarray(inside)))
  return out.astype(np.float32)
