"""Dense N-d interpolation kernels (gather-based, XLA).

This module is the device replacement for the CPU interpolation stack
the reference leans on: `scipy.ndimage.map_coordinates`
(/root/reference/warp.py:196,309-314), OpenCV `cv.remap` incl. Lanczos4
(/root/reference/warp.py:156-165), and
`scipy.interpolate.RegularGridInterpolator` (/root/reference/warp.py:144-155).

Design notes:
  * Sampling is expressed as a statically-unrolled sum over K^dim taps of
    vectorized gathers — XLA fuses the weight computation with gathers and
    keeps everything on device; there is no scattered interpolation anywhere.
  * NaN handling is a first-class contract: with `cval=nan` (default for
    'constant' mode) out-of-bounds taps poison the output, which is exactly
    the coordinate-map invalid-propagation semantics the framework relies on.
  * Kernels: nearest (K=1), linear (K=2), cubic Catmull-Rom with a=-0.75
    matching OpenCV INTER_CUBIC (K=4), Lanczos4 (K=8) matching
    OpenCV INTER_LANCZOS4.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

_KERNEL_TAPS = {
    'nearest': 1,
    'linear': 2,
    'cubic': 4,
    'lanczos': 8,
}


def kernel_taps(method: str) -> int:
  if method not in _KERNEL_TAPS:
    raise ValueError(f'Unknown interpolation method: {method!r}')
  return _KERNEL_TAPS[method]


def _cubic_weights(t: jnp.ndarray) -> list[jnp.ndarray]:
  """Keys cubic (a = -0.75, OpenCV convention) weights for taps -1..2."""
  a = -0.75
  # Distances of the 4 taps from the sample point: 1+t, t, 1-t, 2-t.
  d0 = 1.0 + t
  d1 = t
  d2 = 1.0 - t
  d3 = 2.0 - t

  def w_near(d):  # |d| <= 1
    return (a + 2.0) * d**3 - (a + 3.0) * d**2 + 1.0

  def w_far(d):  # 1 < |d| < 2
    return a * d**3 - 5.0 * a * d**2 + 8.0 * a * d - 4.0 * a

  return [w_far(d0), w_near(d1), w_near(d2), w_far(d3)]


def _lanczos_weights(t: jnp.ndarray) -> list[jnp.ndarray]:
  """Lanczos4 weights for taps -3..4, normalized to sum to 1."""
  ws = []
  for i in range(-3, 5):
    d = t - i
    # sinc(d) * sinc(d/4) with the removable singularity at d=0. The
    # singular point is replaced before the division too: a NaN computed
    # in the unselected branch can survive fusion into a consumer.
    near = jnp.abs(d) < 1e-7
    x = jnp.pi * jnp.where(near, 1.0, d)
    ws.append(jnp.where(near, 1.0,
                        4.0 * jnp.sin(x) * jnp.sin(x / 4.0) / (x * x)))
  total = sum(ws)
  return [w / total for w in ws]


def _tap_weights(t: jnp.ndarray, method: str) -> tuple[list[int],
                                                       list[jnp.ndarray]]:
  """Returns (tap offsets relative to floor coord, per-tap weights)."""
  if method == 'nearest':
    return [0], [jnp.ones_like(t)]
  if method == 'linear':
    return [0, 1], [1.0 - t, t]
  if method == 'cubic':
    return [-1, 0, 1, 2], _cubic_weights(t)
  if method == 'lanczos':
    return list(range(-3, 5)), _lanczos_weights(t)
  raise ValueError(f'Unknown interpolation method: {method!r}')


@functools.partial(jax.jit, static_argnames=['method', 'mode'])
def sample(
    image: jnp.ndarray,
    coords: jnp.ndarray,
    method: str = 'linear',
    mode: str = 'constant',
    cval: float = np.nan,
) -> jnp.ndarray:
  """Samples `image` at fractional `coords`.

  Args:
    image: [d0, d1, ...] source array (any rank >= 1)
    coords: [dim, *out_shape] sample coordinates in image index space,
      ordered like the image axes
    method: 'nearest' | 'linear' | 'cubic' | 'lanczos'
    mode: 'constant' (out-of-bounds -> cval) or 'nearest' (clamp to edge)
    cval: fill value for 'constant' mode

  Returns:
    [*out_shape] sampled values (float32)
  """
  dim = coords.shape[0]
  if dim != image.ndim:
    raise ValueError(f'coords dim {dim} != image rank {image.ndim}')
  image = image.astype(jnp.float32)
  coords = coords.astype(jnp.float32)

  # Invalid (NaN) coordinates always yield NaN output, regardless of mode —
  # this is the coordinate-map invalid-propagation contract.
  nan_coords = jnp.any(jnp.isnan(coords), axis=0)
  coords = jnp.nan_to_num(coords)

  if method == 'nearest':
    base = jnp.round(coords).astype(jnp.int32)
    frac = jnp.zeros_like(coords)
  else:
    base = jnp.floor(coords).astype(jnp.int32)
    frac = coords - base

  offsets_per_axis = []
  weights_per_axis = []
  for axis in range(dim):
    offs, ws = _tap_weights(frac[axis], method)
    offsets_per_axis.append(offs)
    weights_per_axis.append(ws)

  shape = np.array(image.shape)
  out = jnp.zeros(coords.shape[1:], dtype=jnp.float32)

  # Statically unrolled accumulation over the K^dim tap lattice. XLA CSEs
  # the shared index computations and fuses the gathers.
  def _accumulate(axis, idx, weight):
    nonlocal out
    if axis == dim:
      gathered = image[tuple(idx)]
      if mode == 'constant':
        oob = jnp.zeros(coords.shape[1:], dtype=bool)
        for a, raw in enumerate(raw_idx):
          oob |= (raw < 0) | (raw >= shape[a])
        gathered = jnp.where(oob, cval, gathered)
      # Zero-weight taps must not poison the output (0 * NaN = NaN), e.g.
      # the +1 linear tap at an exact grid point next to the edge.
      contrib = weight * gathered
      out = out + jnp.where(weight == 0.0, 0.0, contrib)
      return
    for off, w in zip(offsets_per_axis[axis], weights_per_axis[axis]):
      raw = base[axis] + off
      raw_idx.append(raw)
      idx.append(jnp.clip(raw, 0, shape[axis] - 1))
      _accumulate(axis + 1, idx, weight * w)
      idx.pop()
      raw_idx.pop()

  raw_idx: list[jnp.ndarray] = []
  _accumulate(0, [], jnp.ones(coords.shape[1:], dtype=jnp.float32))
  return jnp.where(nan_coords, jnp.nan, out)


def map_coordinates(
    image: jnp.ndarray,
    coords: Sequence[jnp.ndarray] | jnp.ndarray,
    order: int = 1,
    mode: str = 'constant',
    cval: float = np.nan,
) -> jnp.ndarray:
  """scipy.ndimage.map_coordinates-compatible wrapper around `sample`.

  Supports order 0 (nearest), 1 (linear) and 3 (cubic).
  """
  method = {0: 'nearest', 1: 'linear', 3: 'cubic'}.get(order)
  if method is None:
    raise ValueError(f'Unsupported interpolation order: {order}')
  coords = jnp.asarray(coords)
  return sample(image, coords, method=method, mode=mode, cval=cval)


@functools.partial(jax.jit, static_argnames=['extrapolate'])
def grid_sample_linear(
    values: jnp.ndarray,
    coords: jnp.ndarray,
    extrapolate: bool = True,
) -> jnp.ndarray:
  """Bilinear/trilinear sampling with optional *linear extrapolation*.

  Equivalent to scipy's RegularGridInterpolator(..., fill_value=None) as
  used for coordinate-map densification (/root/reference/warp.py:144-155):
  queries outside the grid extent are linearly extrapolated from the edge
  cell. Implemented by clamping the cell index to [0, n-2] while keeping
  the unclamped fraction — the linear formula then extrapolates naturally.

  Args:
    values: [d0, d1, ...] grid values
    coords: [dim, *out_shape] query coordinates in grid index space
    extrapolate: if False, out-of-range queries clamp to the edge value

  Returns:
    [*out_shape] sampled values
  """
  dim = coords.shape[0]
  values = values.astype(jnp.float32)
  coords = coords.astype(jnp.float32)
  shape = np.array(values.shape)

  if not extrapolate:
    coords = jnp.stack(
        [jnp.clip(coords[a], 0.0, shape[a] - 1.0) for a in range(dim)])

  base = jnp.clip(jnp.floor(coords).astype(jnp.int32), 0,
                  (shape - 2).reshape((dim,) + (1,) * (coords.ndim - 1)))
  frac = coords - base

  out = jnp.zeros(coords.shape[1:], dtype=jnp.float32)
  for corner in range(2**dim):
    idx = []
    w = jnp.ones(coords.shape[1:], dtype=jnp.float32)
    for axis in range(dim):
      if corner & (1 << axis):
        idx.append(base[axis] + 1)
        w = w * frac[axis]
      else:
        idx.append(base[axis])
        w = w * (1.0 - frac[axis])
    out = out + w * values[tuple(idx)]
  return out


@functools.partial(jax.jit, static_argnames=['scale', 'phase', 'out_shape'])
def upsample_map_linear(values: jnp.ndarray, scale: int,
                        phase: tuple[int, int],
                        out_shape: tuple[int, int]) -> jnp.ndarray:
  """Gather-free dense upsampling of a regular grid (integer scale).

  Equivalent to `grid_sample_linear(values, ((y + phase_y) / scale,
  (x + phase_x) / scale))` — i.e. bilinear interpolation with linear
  edge-cell extrapolation — but built from `jnp.repeat` + static slices
  and periodic fraction planes, avoiding gathers entirely.

  Args:
    values: [c, my, mx] grid values
    scale: integer upsampling factor (grid spacing in output pixels)
    phase: (py, px) integer offsets: output pixel p samples grid
      coordinate (p + phase) / scale
    out_shape: (oy, ox) output extent

  Returns:
    [c, oy, ox] densified field
  """
  oy, ox = out_shape
  py, px = phase
  c, my, mx = values.shape
  values = values.astype(jnp.float32)

  def extend(v, axis, needed):
    """Appends linearly-extrapolated nodes; prepends for negative bases."""
    n = v.shape[axis]
    lo = 0
    hi = needed - n + 1  # +1: the interpolation uses base and base+1
    out = v
    if hi > 0:
      last = jax.lax.slice_in_dim(out, n - 1, n, axis=axis)
      prev = jax.lax.slice_in_dim(out, n - 2, n - 1, axis=axis)
      grad = last - prev
      ext = [last + (k + 1) * grad for k in range(hi)]
      out = jnp.concatenate([out] + ext, axis=axis)
    if lo > 0:  # pragma: no cover - negative phases are normalized out
      first = jax.lax.slice_in_dim(out, 0, 1, axis=axis)
      second = jax.lax.slice_in_dim(out, 1, 2, axis=axis)
      grad = first - second
      ext = [first + (lo - k) * grad for k in range(lo)]
      out = jnp.concatenate(ext + [out], axis=axis)
    return out

  if py < 0 or px < 0:
    raise ValueError('phases must be non-negative (shift the output box)')

  max_by = (oy - 1 + py) // scale
  max_bx = (ox - 1 + px) // scale
  v = extend(values, 1, max_by + 1)
  v = extend(v, 2, max_bx + 1)

  # y axis: rows repeat `scale` times; frac plane is periodic.
  r0 = jnp.repeat(v, scale, axis=1)[:, py:py + oy]
  r1 = jnp.repeat(v[:, 1:], scale, axis=1)[:, py:py + oy]
  fy = (((jnp.arange(oy, dtype=jnp.float32) + py) % scale)
        / scale)[None, :, None]
  a = (1.0 - fy) * r0 + fy * r1

  c0 = jnp.repeat(a, scale, axis=2)[:, :, px:px + ox]
  c1 = jnp.repeat(a[:, :, 1:], scale, axis=2)[:, :, px:px + ox]
  fx = (((jnp.arange(ox, dtype=jnp.float32) + px) % scale)
        / scale)[None, None, :]
  return (1.0 - fx) * c0 + fx * c1


def sample_channels(
    image: jnp.ndarray,
    coords: jnp.ndarray,
    method: str = 'linear',
    mode: str = 'constant',
    cval: float = np.nan,
) -> jnp.ndarray:
  """Samples a [c, *spatial] array at [dim, *out] coords; returns [c, *out]."""
  return jax.vmap(
      lambda img: sample(img, coords, method=method, mode=mode, cval=cval)
  )(image)
