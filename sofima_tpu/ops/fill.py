"""Hole filling and nearest-valid extrapolation for dense fields on device.

JAX replacement for the Qhull/Delaunay scattered interpolation the
reference uses in `fill_missing` (/root/reference/map_utils.py:227-304,
70-117). Instead of triangulating valid samples on the host, we:

  * interpolate holes with a multigrid harmonic fill (pull-push pyramid
    initialization + Jacobi relaxation with Dirichlet data at valid
    pixels) — harmonic interpolation reproduces linear fields exactly,
    matching the piecewise-linear Delaunay behavior on smooth maps;
  * restrict interpolation to the rectilinear span hull of the valid set
    (a grid-friendly approximation of the convex-hull fill region that
    Delaunay interpolation implies);
  * extrapolate with nearest-valid values found by jump flooding
    (O(log n) vectorized passes), replacing NearestNDInterpolator.

All steps are jnp programs: no host round trips, no dynamic shapes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _shift(arr: jnp.ndarray, offsets, fill) -> jnp.ndarray:
  """Shifts `arr` by integer offsets per axis, filling vacated area."""
  for axis, off in enumerate(offsets):
    if off == 0:
      continue
    pad = [(0, 0)] * arr.ndim
    if off > 0:
      pad[axis] = (off, 0)
      arr = jnp.pad(arr, pad, constant_values=fill)
      arr = jax.lax.slice_in_dim(arr, 0, arr.shape[axis] - off, axis=axis)
    else:
      pad[axis] = (0, -off)
      arr = jnp.pad(arr, pad, constant_values=fill)
      arr = jax.lax.slice_in_dim(arr, -off, arr.shape[axis], axis=axis)
  return arr


def _neighbor_offsets(dim: int, step: int):
  if dim == 2:
    rng = [(-step, 0, step)] * 2
  else:
    rng = [(-step, 0, step)] * 3
  out = []

  def rec(axis, cur):
    if axis == dim:
      if any(cur):
        out.append(tuple(cur))
      return
    for v in rng[axis]:
      rec(axis + 1, cur + [v])

  rec(0, [])
  return out


@jax.jit
def nearest_fill(values: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
  """Fills invalid entries with the value of the nearest valid grid point.

  Args:
    values: [c, *spatial] field (2d or 3d spatial)
    valid: [*spatial] bool mask of valid entries

  Returns:
    [c, *spatial] field with every entry filled from its (Euclidean-)nearest
    valid sample; unchanged where `valid`. If nothing is valid, returns the
    input unchanged.
  """
  dim = valid.ndim
  spatial = valid.shape
  big = jnp.float32(1e12)

  grids = jnp.meshgrid(
      *[jnp.arange(n, dtype=jnp.float32) for n in spatial], indexing='ij')
  coords = jnp.stack(grids)  # [dim, *spatial]
  seed = jnp.where(valid[None], coords, big)

  max_side = int(max(spatial))
  steps = []
  s = 1
  while s < max_side:
    s *= 2
  while s >= 1:
    steps.append(s)
    s //= 2

  def pass_fn(seed, step):
    best = seed
    best_d2 = jnp.where(
        jnp.any(best >= big, axis=0),
        big,
        sum((best[a] - coords[a]) ** 2 for a in range(dim)),
    )
    for offs in _neighbor_offsets(dim, step):
      cand = _shift(seed, (0,) + offs, big)
      d2 = jnp.where(
          jnp.any(cand >= big, axis=0),
          big,
          sum((cand[a] - coords[a]) ** 2 for a in range(dim)),
      )
      better = d2 < best_d2
      best = jnp.where(better[None], cand, best)
      best_d2 = jnp.where(better, d2, best_d2)
    return best

  for step in steps:  # statically unrolled: log2(n) passes
    seed = pass_fn(seed, step)

  has_seed = jnp.all(seed < big, axis=0)
  idx = tuple(jnp.clip(seed[a].astype(jnp.int32), 0, spatial[a] - 1)
              for a in range(dim))
  gathered = values[(slice(None),) + idx]
  out = jnp.where(valid[None], values, gathered)
  # If there are no valid entries at all, keep the input as-is.
  return jnp.where(has_seed[None], out, values)


def span_hull(valid: jnp.ndarray) -> jnp.ndarray:
  """Rectilinear span hull: points between valid samples along every axis."""
  hull = jnp.ones_like(valid)
  for axis in range(valid.ndim):
    fwd = jnp.cumsum(valid, axis=axis) > 0
    bwd = jnp.flip(
        jnp.cumsum(jnp.flip(valid, axis=axis), axis=axis) > 0, axis=axis)
    hull &= fwd & bwd
  return hull


def _downsample2(values: jnp.ndarray, weight: jnp.ndarray):
  """2x valid-weighted average downsampling along all spatial axes."""
  dim = weight.ndim
  v = values * weight[None]
  w = weight
  for axis in range(dim):
    n = v.shape[axis + 1]
    if n % 2 == 1:  # pad to even with zero weight
      pad_v = [(0, 0)] * v.ndim
      pad_v[axis + 1] = (0, 1)
      v = jnp.pad(v, pad_v)
      pad_w = [(0, 0)] * w.ndim
      pad_w[axis] = (0, 1)
      w = jnp.pad(w, pad_w)
    idx0 = [slice(None)] * v.ndim
    idx1 = [slice(None)] * v.ndim
    idx0[axis + 1] = slice(0, None, 2)
    idx1[axis + 1] = slice(1, None, 2)
    v = v[tuple(idx0)] + v[tuple(idx1)]
    widx0 = [slice(None)] * w.ndim
    widx1 = [slice(None)] * w.ndim
    widx0[axis] = slice(0, None, 2)
    widx1[axis] = slice(1, None, 2)
    w = w[tuple(widx0)] + w[tuple(widx1)]
  return v / jnp.maximum(w, 1e-12)[None], w


def _upsample2(values: jnp.ndarray, target_shape) -> jnp.ndarray:
  """Linear 2x upsampling of [c, *spatial] to `target_shape` (spatial)."""
  dim = len(target_shape)
  coords = jnp.meshgrid(
      *[(jnp.arange(n, dtype=jnp.float32) - 0.5) / 2.0 for n in target_shape],
      indexing='ij')
  coords = jnp.stack(coords)
  src_shape = np.array(values.shape[1:])
  base = jnp.clip(jnp.floor(coords).astype(jnp.int32), 0,
                  (src_shape - 2).reshape((dim,) + (1,) * dim))
  base = jnp.where((src_shape == 1).reshape((dim,) + (1,) * dim), 0, base)
  frac = jnp.clip(coords - base, 0.0, 1.0)
  out = jnp.zeros((values.shape[0],) + tuple(target_shape), jnp.float32)
  for corner in range(2**dim):
    idx = []
    w = jnp.ones(tuple(target_shape), jnp.float32)
    for axis in range(dim):
      hi = bool(corner & (1 << axis))
      step = jnp.minimum(1, src_shape[axis] - 1)
      idx.append(base[axis] + (step if hi else 0))
      w = w * (frac[axis] if hi else (1.0 - frac[axis]))
    out = out + w[None] * values[(slice(None),) + tuple(idx)]
  return out


def _jacobi(values: jnp.ndarray, orig: jnp.ndarray, valid: jnp.ndarray,
            iters: int) -> jnp.ndarray:
  """Jacobi relaxation of the Laplace equation on invalid pixels."""
  dim = valid.ndim

  def step(_, v):
    acc = jnp.zeros_like(v)
    cnt = 0
    for axis in range(dim):
      for off in (-1, 1):
        offs = [0] * dim
        offs[axis] = off
        # Edge-replicated shift keeps border means unbiased.
        shifted = _shift(v, [0] + offs, 0.0)
        edge = _shift(jnp.ones_like(valid, dtype=jnp.float32),
                      offs, 0.0)
        shifted = shifted + (1.0 - edge)[None] * v
        acc = acc + shifted
        cnt += 1
    mean = acc / cnt
    return jnp.where(valid[None], orig, mean)

  return jax.lax.fori_loop(0, iters, step, values)


@functools.partial(jax.jit, static_argnames=['jacobi_iters'])
def harmonic_fill(values: jnp.ndarray, valid: jnp.ndarray,
                  jacobi_iters: int = 16) -> jnp.ndarray:
  """Fills invalid entries by (approximately) harmonic interpolation.

  Multigrid scheme: a valid-weighted averaging pyramid provides the
  coarse initialization (pull phase); each finer level is initialized by
  linear upsampling (push phase) and relaxed with Jacobi sweeps that keep
  valid pixels fixed (Dirichlet data).

  Args:
    values: [c, *spatial] field
    valid: [*spatial] bool mask
    jacobi_iters: relaxation sweeps per pyramid level

  Returns:
    [c, *spatial] field with all entries finite (if any input was valid)
  """
  orig = jnp.where(valid[None], values, 0.0).astype(jnp.float32)

  # Pull: build the pyramid.
  levels = [(orig, valid.astype(jnp.float32))]
  while max(levels[-1][1].shape) > 2:
    v, w = _downsample2(*levels[-1])
    levels.append((v, jnp.minimum(w, 1.0)))

  # Coarsest level: fill remaining holes with the mean of valid entries.
  v, w = levels[-1]
  wsum = jnp.maximum(jnp.sum(w), 1e-12)
  mean = jnp.sum(v * w[None], axis=tuple(range(1, v.ndim))) / wsum
  filled = jnp.where(w[None] > 0, v,
                     mean.reshape((-1,) + (1,) * (v.ndim - 1)))

  # Push: upsample and relax level by level.
  for v, w in reversed(levels[:-1]):
    filled = _upsample2(filled, v.shape[1:])
    lv_valid = w > 0
    filled = jnp.where(lv_valid[None], v, filled)
    filled = _jacobi(filled, v, lv_valid, jacobi_iters)

  return filled


@functools.partial(jax.jit, static_argnames=['extrapolate', 'jacobi_iters'])
def fill_invalid(values: jnp.ndarray, valid: jnp.ndarray,
                 extrapolate: bool = False,
                 jacobi_iters: int = 16) -> jnp.ndarray:
  """Interpolates holes (span hull) and optionally extrapolates outside.

  Mirrors the reference fill_missing contract
  (/root/reference/map_utils.py:227-304): interpolation inside the data
  region, optional nearest-neighbor extrapolation outside, untouched NaN
  elsewhere.
  """
  filled = harmonic_fill(values, valid, jacobi_iters=jacobi_iters)
  hull = span_hull(valid)
  out = jnp.where(hull[None], filled, jnp.nan)
  out = jnp.where(valid[None], values, out)
  if extrapolate:
    out = nearest_fill(jnp.where(hull[None], out, jnp.nan), hull | valid)
  any_valid = jnp.any(valid)
  return jnp.where(any_valid, out, values)
