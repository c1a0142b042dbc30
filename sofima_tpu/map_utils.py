"""Coordinate-map algebra for volume-backed coordinate maps.

A coordinate map is a dense `[2 or 3, z, y, x]` float array of *relative*
offsets (Δx, Δy[, Δz]), channel order xy[z], mapping `x -> u = x + Δx` etc.
Maps have a `stride` (pixel distance between map nodes) and may be anchored
by a BoundingBox. Invalid entries are NaN. This mirrors the data contract
of the reference (/root/reference/map_utils.py:15-53) — the compatibility
surface of the whole framework — while replacing every scattered
(Qhull/Delaunay) CPU algorithm with dense, jit-compiled device programs:

  * `fill_missing`    — multigrid harmonic fill + jump-flooding
                        extrapolation (ops.fill) instead of
                        LinearND/NearestNDInterpolator
                        (/root/reference/map_utils.py:227-304)
  * `invert_map`      — damped fixed-point inversion with bilinear map
                        sampling instead of scattered interpolation of
                        swapped points (/root/reference/map_utils.py:392-487)
  * `resample_map`    — dense grid resampling with NaN propagation instead
                        of per-section Delaunay (/root/reference/map_utils.py:490-546)
  * `compose_maps(_fast)` — vmapped gather composition
                        (/root/reference/map_utils.py:549-734)

Composition/inversion identities preserved:
  comp(a, b)^-1 = comp(b^-1, a^-1)
  warp(img, comp(a, b)) = warp(warp(img, b), a)
"""

from __future__ import annotations

import collections.abc
import functools
import logging
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sofima_tpu.ops import fill as fill_ops
from sofima_tpu.ops import interp
from sofima_tpu.utils.bounding_box import BoundingBox

StrideZYX = float | Sequence[float]
ShapeZYX = tuple[int, int] | tuple[int, int, int]


def _as_vec(value: StrideZYX, dim: int) -> tuple[float, ...]:
  if not isinstance(value, collections.abc.Sequence):
    return (float(value),) * dim
  assert len(value) == dim, f'Dimension mismatch: {value=} vs {dim=}'
  return tuple(float(v) for v in value)


def _identity_map_absolute(coord_shape: ShapeZYX,
                           stride: StrideZYX) -> list[np.ndarray]:
  """Identity map in absolute form: [z -> z·sz,] y -> y·sy, x -> x·sx."""
  dim = len(coord_shape)
  stride = _as_vec(stride, dim)
  return [
      hx * step for hx, step in zip(
          np.mgrid[[np.s_[:s] for s in coord_shape]], stride)
  ]


def to_absolute(coord_map: np.ndarray, stride: StrideZYX,
                box: BoundingBox | None = None) -> np.ndarray:
  """Relative (Δ offsets) -> absolute (target positions) conversion."""
  coord_map = np.array(coord_map)
  dim = coord_map.shape[0]
  stride = _as_vec(stride, dim)
  off_zyx = _identity_map_absolute(coord_map.shape[-dim:], stride)
  if box is not None:
    if not np.all(coord_map.shape[-dim:][::-1] == box.size[:dim]):
      raise ValueError(
          f'box size {box.size} mismatch with map shape {coord_map.shape}')
    off_zyx = [
        o + start * step for o, step, start in zip(
            off_zyx, stride, box.start[:dim][::-1])
    ]
  for i in range(dim):
    coord_map[i, ...] += off_zyx[-(i + 1)]
  return coord_map


def to_relative(coord_map: np.ndarray, stride: StrideZYX,
                box: BoundingBox | None = None) -> np.ndarray:
  """Absolute (target positions) -> relative (Δ offsets) conversion."""
  coord_map = np.array(coord_map)
  dim = coord_map.shape[0]
  stride = _as_vec(stride, dim)
  off_zyx = _identity_map_absolute(coord_map.shape[-dim:], stride)
  if box is not None:
    if not np.all(coord_map.shape[-dim:][::-1] == box.size[:dim]):
      raise ValueError(
          f'box size {box.size} mismatch with map shape {coord_map.shape}')
    for i in range(dim):
      off_zyx[-(i + 1)] += box.start[i] * stride[-(i + 1)]
  for i in range(dim):
    coord_map[i, ...] -= off_zyx[-(i + 1)]
  return coord_map


def fill_missing(coord_map: np.ndarray, *, extrapolate: bool = False,
                 invalid_to_zero: bool = False,
                 interpolate_first: bool = True) -> np.ndarray:
  """Fills NaN entries of a coordinate map.

  2d maps ([2, z, y, x]) are treated as independent per-z sections.
  """
  coord_map = np.asarray(coord_map, dtype=np.float32)
  if not np.any(np.isnan(coord_map)):
    return coord_map.copy()

  dim = coord_map.shape[0]

  def _one(section: jnp.ndarray) -> jnp.ndarray:
    valid = jnp.all(jnp.isfinite(section), axis=0)
    if interpolate_first:
      return fill_ops.fill_invalid(section, valid, extrapolate=extrapolate)
    if extrapolate:
      return fill_ops.nearest_fill(section, valid)
    return section

  if dim == 2:
    sections = jnp.asarray(np.moveaxis(coord_map, 1, 0))  # [z, 2, y, x]
    out = np.array(jax.vmap(_one)(sections))
    out = np.moveaxis(out, 0, 1)
  else:
    out = np.array(_one(jnp.asarray(coord_map)))

  if invalid_to_zero:
    # Fully-invalid sections/volumes reset to the identity map (zeros).
    if dim == 2:
      all_invalid = np.all(np.isnan(coord_map), axis=(0, 2, 3))
      out[:, all_invalid, :, :] = 0.0
    elif np.all(np.isnan(coord_map)):
      out[...] = 0.0
  return out


def outer_box(coord_map: np.ndarray, box: BoundingBox, stride: StrideZYX,
              target_len: StrideZYX | None = None) -> BoundingBox:
  """Bounding box covering all (u, v[, w]) targets of the map."""
  abs_map = to_absolute(np.asarray(coord_map, np.float64), stride, box)
  extents_xyz = [(np.nanmin(c), np.nanmax(c)) for c in abs_map]

  dim = coord_map.shape[0]
  target_len_xyz = _as_vec(
      target_len if target_len is not None else stride, dim)[::-1]
  start = box.start.copy()
  size = box.size.copy()
  for i, ((x_min, x_max), tl) in enumerate(zip(extents_xyz, target_len_xyz)):
    lo = int(x_min) // int(tl)
    start[i] = lo
    size[i] = -(int(-x_max) // int(tl)) - lo + 1
  return BoundingBox(start, size)


def inner_box(coord_map: np.ndarray, box: BoundingBox,
              stride: StrideZYX) -> BoundingBox:
  """Box of targets guaranteed to be covered by the map's image."""
  dim = coord_map.shape[0]
  assert dim in (2, 3)
  stride = _as_vec(stride, dim)
  int_map = to_absolute(
      fill_missing(coord_map, extrapolate=True), stride, box)
  x0 = np.max(np.min(int_map[0, ...], axis=-1))
  x1 = np.min(np.max(int_map[0, ...], axis=-1))
  y0 = np.max(np.min(int_map[1, ...], axis=-2))
  y1 = np.min(np.max(int_map[1, ...], axis=-2))

  x0 = int(-(-x0 // stride[-1]))
  y0 = int(-(-y0 // stride[-2]))
  x1 = int(x1 // stride[-1])
  y1 = int(y1 // stride[-2])

  if dim == 2:
    return BoundingBox(
        start=(x0, y0, int(box.start[2])),
        size=(x1 - x0 + 1, y1 - y0 + 1, int(box.size[2])))

  z0 = np.max(np.min(int_map[2, ...], axis=-3))
  z1 = np.min(np.max(int_map[2, ...], axis=-3))
  z0 = int(-(-z0 // stride[0]))
  z1 = int(z1 // stride[0])
  return BoundingBox(start=(x0, y0, z0),
                     size=(x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1))


@functools.partial(
    jax.jit,
    static_argnames=['num_iters', 'tol', 'newton_iters', 'return_stats',
                     'shift_bound', 'shift_origin'])
def _invert_section(abs_map_xy: jnp.ndarray, src_start_yx: jnp.ndarray,
                    query_xy: jnp.ndarray, stride_yx: jnp.ndarray,
                    num_iters: int = 32, tol: float = 1e-2,
                    newton_iters: int = 8, return_stats: bool = False,
                    shift_bound: int | None = None,
                    shift_origin: tuple[int, int] = (0, 0)):
  """Fixed-point + Newton inversion of one (2d or 3d) absolute map.

  Solves F(p) = q for p, where F(p) = p + d(p) and d is the relative
  offset field sampled bilinearly from the map grid. Phase 1 iterates
  the damped fixed point p <- p + 0.6 (q - F(p)), which converges for
  the near-identity smooth maps produced by mesh relaxation. Phase 2
  re-seeds any query that failed — NaN'd out or still above
  tolerance, e.g. near folds where the fixed point's contraction factor
  approaches 1 — and runs damped Newton steps with the sampled Jacobian
  J = I + grad(d) (2x2 Cramer solve in 2d, 3x3 adjugate solve in 3d):
  this recovers stiff-but-invertible regions that the
  plain iteration loses (the robustness envelope of the reference's
  dim-generic scattered inversion,
  /root/reference/map_utils.py:392-487). Truly
  folded neighborhoods (|det J| ~ 0) still fail the residual gate and
  yield NaN — mirroring the convex-hull NaN semantics.

  Args:
    abs_map_xy: [dim, *grid] absolute map (channels in xy[z] order)
    src_start_yx: [dim] grid origin ([z]yx order, in node units)
    query_xy: [dim, *out] query points in physical units, xy[z] channels
    stride_yx: [dim] node spacing ([z]yx)
    num_iters: fixed-point iterations
    tol: residual tolerance in units of stride
    newton_iters: Newton refinement iterations (0 disables)
    return_stats: also return the fraction of queries that failed the
      residual gate (divergence telemetry)

  Returns:
    [dim, *out] source positions (absolute, xy[z] channels), NaN where
    inversion failed; with `return_stats`, a (result, failed_fraction)
    tuple.
  """
  dim = abs_map_xy.shape[0]
  # Relative offsets on the grid: d = F(grid) - grid.
  grid_zyx = jnp.meshgrid(
      *[jnp.arange(n, dtype=abs_map_xy.dtype) for n in abs_map_xy.shape[1:]],
      indexing='ij')
  d_xy = jnp.stack([
      abs_map_xy[c] -
      (grid_zyx[dim - 1 - c] + src_start_yx[dim - 1 - c]) * stride_yx[dim - 1 - c]
      for c in range(dim)
  ])

  def to_idx(p_xy):
    # Physical -> grid index coords, zyx-ordered for sampling.
    return jnp.stack([
        p_xy[dim - 1 - a] / stride_yx[a] - src_start_yx[a]
        for a in range(dim)
    ])

  if dim == 2 and shift_bound is not None:
    # Gather-free sampling: every fixed-point iteration otherwise pays
    # a per-pixel gather. The queries form a UNIT-SPACED grid at
    # integer origin `shift_origin` in map-index space (the invert_map /
    # pipeline geometry), and iterates stay within `shift_bound` nodes
    # of their own query — so bilinear sampling decomposes over a static
    # integer-shift lattice of contiguous slices. Matches interp.sample's semantics: zero-weight taps are
    # inert, any covered out-of-grid tap or NaN coordinate yields NaN.
    bnd = int(shift_bound)
    org_y, org_x = int(shift_origin[0]), int(shift_origin[1])
    oy_n, ox_n = query_xy.shape[1], query_xy.shape[2]
    g0, g1 = d_xy.shape[1], d_xy.shape[2]
    taps = list(range(-bnd - 1, bnd + 3))
    pad_y0 = bnd + 3 + max(0, -org_y)
    pad_y1 = bnd + 3 + max(0, org_y + oy_n - g0)
    pad_x0 = bnd + 3 + max(0, -org_x)
    pad_x1 = bnd + 3 + max(0, org_x + ox_n - g1)
    d_pad = jnp.pad(d_xy, ((0, 0), (pad_y0, pad_y1), (pad_x0, pad_x1)),
                    constant_values=np.nan)
    ioy = jax.lax.broadcasted_iota(jnp.float32, (oy_n, ox_n), 0)
    iox = jax.lax.broadcasted_iota(jnp.float32, (oy_n, ox_n), 1)

    def sample_d(p_xy):
      idx = to_idx(p_xy)
      dy_ = idx[0] - ioy - org_y
      dx_ = idx[1] - iox - org_x
      bad = (~(jnp.abs(dy_) <= bnd + 1)) | (~(jnp.abs(dx_) <= bnd + 1))
      acc0 = jnp.zeros((oy_n, ox_n), jnp.float32)
      acc1 = jnp.zeros((oy_n, ox_n), jnp.float32)
      for sy_t in taps:
        wy = jnp.maximum(0.0, 1.0 - jnp.abs(dy_ - sy_t))
        y0 = pad_y0 + org_y + sy_t
        for sx_t in taps:
          w = wy * jnp.maximum(0.0, 1.0 - jnp.abs(dx_ - sx_t))
          x0 = pad_x0 + org_x + sx_t
          win0 = jax.lax.slice(d_pad[0], (y0, x0), (y0 + oy_n, x0 + ox_n))
          win1 = jax.lax.slice(d_pad[1], (y0, x0), (y0 + oy_n, x0 + ox_n))
          keep = w > 0.0
          acc0 = acc0 + jnp.where(keep, w * win0, 0.0)
          acc1 = acc1 + jnp.where(keep, w * win1, 0.0)
      return jnp.stack([jnp.where(bad, jnp.nan, acc0),
                        jnp.where(bad, jnp.nan, acc1)])
  else:

    def sample_d(p_xy):
      return interp.sample_channels(d_xy, to_idx(p_xy), method='linear',
                                    mode='constant', cval=np.nan)

  def body(_, p):
    f = p + sample_d(p)
    step = query_xy - f
    p_new = p + 0.6 * step
    # Keep NaN (diverged / outside) pinned so it cannot resurrect.
    return jnp.where(jnp.isnan(p_new), jnp.nan, p_new)

  p = jax.lax.fori_loop(0, num_iters, body, query_xy)
  max_stride = jnp.max(stride_yx)

  def residual_ok(p_cur):
    resid = jnp.abs(p_cur + sample_d(p_cur) - query_xy)
    return jnp.all(resid <= tol * max_stride, axis=0)

  if dim == 2 and newton_iters > 0:
    # Sampled Jacobian entries (pixel/pixel): gradients of d wrt (y, x).
    gyx = [jnp.gradient(d_xy[c]) for c in range(2)]  # [(ddc/dy, ddc/dx)]
    jac_planes = jnp.stack([
        gyx[0][1] / stride_yx[1],  # a  = d(dx)/dx
        gyx[0][0] / stride_yx[0],  # b  = d(dx)/dy
        gyx[1][1] / stride_yx[1],  # c_ = d(dy)/dx
        gyx[1][0] / stride_yx[0],  # e  = d(dy)/dy
    ])

    ok0 = residual_ok(p)
    # Re-seed failed queries from q itself (NaN pins cannot resurrect in
    # phase 1; Newton gets a fresh start).
    p_n = jnp.where((~ok0 | jnp.isnan(p[0]) | jnp.isnan(p[1]))[None],
                    query_xy, p)

    def newton_body(_, p_cur):
      d_here = sample_d(p_cur)
      r = query_xy - (p_cur + d_here)
      a, b, c_, e = interp.sample_channels(
          jac_planes, to_idx(p_cur), method='linear', mode='nearest')
      det = (1.0 + a) * (1.0 + e) - b * c_
      # Gate only against numerical explosion at det ~ 0 (true folds);
      # strong compressions (e.g. 0.2x per axis -> det 0.04) are
      # legitimate and need the Newton step most. The trust-region clip
      # below bounds the blow-up for the near-singular survivors.
      safe = jnp.abs(det) > 0.005
      inv_det = jnp.where(safe, 1.0 / jnp.where(safe, det, 1.0), 0.0)
      dx = ((1.0 + e) * r[0] - b * r[1]) * inv_det
      dy = (-c_ * r[0] + (1.0 + a) * r[1]) * inv_det
      step = jnp.where(safe[None], jnp.stack([dx, dy]), 0.6 * r)
      # Trust region: bounded steps keep fold neighborhoods from
      # exploding while still letting strong compressions (|J| << 1,
      # where each Newton step legitimately covers many cells) converge.
      step = jnp.clip(step, -8.0 * max_stride, 8.0 * max_stride)
      p_new = p_cur + step
      return jnp.where(jnp.isnan(p_new), jnp.nan, p_new)

    p_n = jax.lax.fori_loop(0, newton_iters, newton_body, p_n)
    ok_n = residual_ok(p_n)
    # Keep phase-1 answers where they were already good.
    p = jnp.where(ok0[None], p, jnp.where(ok_n[None], p_n, jnp.nan))
    ok = ok0 | ok_n
  elif dim == 3 and newton_iters > 0:
    # 3d Newton rescue: sampled 3x3 Jacobian J = I + M with
    # M[c][j] = d(d_c)/d(axis_j) in pixel/pixel units (c, j in physical
    # xyz order; array axes are zyx, hence the 2 - j flip), solved per
    # query by the adjugate formula. Same det gate / trust region as 2d.
    grads = [jnp.gradient(d_xy[c]) for c in range(3)]  # [d/dz,d/dy,d/dx]
    jac_planes = jnp.stack([
        grads[c][2 - j] / stride_yx[2 - j]
        for c in range(3) for j in range(3)
    ])  # [9, *grid], row-major M[c*3 + j]

    ok0 = residual_ok(p)
    bad0 = ~ok0
    for c in range(3):
      bad0 = bad0 | jnp.isnan(p[c])
    p_n = jnp.where(bad0[None], query_xy, p)

    def newton_body3(_, p_cur):
      r = query_xy - (p_cur + sample_d(p_cur))
      m = interp.sample_channels(jac_planes, to_idx(p_cur),
                                 method='linear', mode='nearest')
      j00, j01, j02 = 1.0 + m[0], m[1], m[2]
      j10, j11, j12 = m[3], 1.0 + m[4], m[5]
      j20, j21, j22 = m[6], m[7], 1.0 + m[8]
      # Cofactors C[i][j]; inverse[i][j] = C[j][i] / det.
      c00 = j11 * j22 - j12 * j21
      c01 = j12 * j20 - j10 * j22
      c02 = j10 * j21 - j11 * j20
      c10 = j02 * j21 - j01 * j22
      c11 = j00 * j22 - j02 * j20
      c12 = j01 * j20 - j00 * j21
      c20 = j01 * j12 - j02 * j11
      c21 = j02 * j10 - j00 * j12
      c22 = j00 * j11 - j01 * j10
      det = j00 * c00 + j01 * c01 + j02 * c02
      # Gate only against numerical explosion at det ~ 0 (true folds);
      # strong compressions are legitimate and need Newton most. The 2d
      # gate (0.005) corresponds to a ~0.07 per-axis scale; in 3d the
      # same per-axis envelope cubes to ~3e-4.
      safe = jnp.abs(det) > 3e-4
      inv_det = jnp.where(safe, 1.0 / jnp.where(safe, det, 1.0), 0.0)
      s0 = (c00 * r[0] + c10 * r[1] + c20 * r[2]) * inv_det
      s1 = (c01 * r[0] + c11 * r[1] + c21 * r[2]) * inv_det
      s2 = (c02 * r[0] + c12 * r[1] + c22 * r[2]) * inv_det
      step = jnp.where(safe[None], jnp.stack([s0, s1, s2]), 0.6 * r)
      step = jnp.clip(step, -8.0 * max_stride, 8.0 * max_stride)
      p_new = p_cur + step
      return jnp.where(jnp.isnan(p_new), jnp.nan, p_new)

    p_n = jax.lax.fori_loop(0, newton_iters, newton_body3, p_n)
    ok_n = residual_ok(p_n)
    p = jnp.where(ok0[None], p, jnp.where(ok_n[None], p_n, jnp.nan))
    ok = ok0 | ok_n
  else:
    ok = residual_ok(p)

  out = jnp.where(ok[None], p, jnp.nan)
  if return_stats:
    return out, 1.0 - jnp.mean(ok.astype(jnp.float32))
  return out


def _record_invert_stats(failed_per_section: np.ndarray) -> None:
  """Divergence telemetry: counters + a warning for high-failure maps."""
  from sofima_tpu.utils import metrics
  worst = float(failed_per_section.max()) if failed_per_section.size else 0.0
  metrics.registry().inc('map_utils', 'invert_map_sections',
                         int(failed_per_section.size))
  metrics.registry().inc(
      'map_utils', 'invert_map_failed_nodes_permille',
      int(round(1000.0 * float(failed_per_section.mean()))) if
      failed_per_section.size else 0)
  if worst > 0.05:
    logging.warning(
        'invert_map: %.1f%% of queries failed to invert in the worst '
        'section (folds or out-of-image regions); downstream fill will '
        'interpolate them.', 100.0 * worst)


def invert_map(coord_map: np.ndarray, src_box: BoundingBox,
               dst_box: BoundingBox, stride: StrideZYX,
               dtype: np.dtype = np.float32) -> np.ndarray:
  """Inverts an (x, y[, z]) -> (u, v[, w]) map over `dst_box`.

  With `dtype=np.float64` the inversion runs in double precision on the
  CPU backend (the reference casts to float64 at
  /root/reference/map_utils.py:415). The origin shift below already
  keeps chunked inversions accurate in float32; float64 matters for
  whole-volume grids whose absolute coordinates exceed ~1e6 pixels.
  """
  compute = np.dtype(dtype)
  coord_map = np.asarray(coord_map, np.float32)
  dim = coord_map.shape[0]
  stride_v = _as_vec(stride, dim)
  # Shift the coordinate origin to dst_box.start for precision.
  src_box = src_box.adjusted_by(start=-dst_box.start, end=-dst_box.start)
  dst_box = dst_box.adjusted_by(start=-dst_box.start, end=-dst_box.start)

  src_start_yx = np.asarray(
      [float(src_box.start[dim - 1 - i]) for i in range(dim)], compute)
  stride_yx = np.asarray(stride_v, compute)

  # Query grid (absolute physical coordinates of dst nodes), xy[z] channels.
  qgrids = np.mgrid[[np.s_[:int(dst_box.size[dim - 1 - i])]
                     for i in range(dim)]]
  query = np.stack([
      (qgrids[dim - 1 - c] + dst_box.start[c]) * stride_v[dim - 1 - c]
      for c in range(dim)
  ]).astype(compute)

  # Span holes by interpolation first (Delaunay spans holes across the
  # triangulation; our dense inversion needs a continuous field). Filling
  # happens on the RELATIVE map — offsets are small, so float32 filling
  # loses nothing, and linear interpolation commutes with adding the
  # (linear) identity part.
  filled = fill_missing(coord_map, extrapolate=False)
  abs_map = to_absolute(filled.astype(compute), stride_v, src_box)

  def run():
    src_j = jnp.asarray(src_start_yx)
    stride_j = jnp.asarray(stride_yx)
    query_j = jnp.asarray(query)
    if dim == 2:
      sections = jnp.asarray(np.moveaxis(abs_map, 1, 0))  # [z, 2, y, x]
      inv, failed = jax.vmap(
          lambda m: _invert_section(m, src_j, query_j, stride_j,
                                    return_stats=True))(sections)
      _record_invert_stats(np.asarray(failed))
      return np.moveaxis(np.array(inv), 0, 1)
    out, failed = _invert_section(jnp.asarray(abs_map), src_j, query_j,
                                  stride_j, return_stats=True)
    _record_invert_stats(np.asarray(failed)[None])
    return np.array(out)

  if compute == np.float64:
    # float64 is a CPU path: accelerators run f64 slowly or not at all.
    with jax.enable_x64(), jax.default_device(jax.devices('cpu')[0]):
      inv = run()
  else:
    inv = run()

  return to_relative(inv.astype(compute), stride_v, dst_box).astype(compute)


@functools.partial(jax.jit, static_argnames=['method'])
def _resample_section(section: jnp.ndarray, coords: jnp.ndarray,
                      method: str) -> jnp.ndarray:
  return interp.sample_channels(section, coords, method=method,
                                mode='constant', cval=np.nan)


def resample_map(coord_map: np.ndarray, src_box: BoundingBox,
                 dst_box: BoundingBox, src_stride: float, dst_stride: float,
                 method: str = 'linear') -> np.ndarray:
  """Resamples a 2d coordinate map to a new node grid/stride.

  Offsets are in pixels and are therefore NOT rescaled; only the node grid
  changes. NaN entries poison interpolated values touching them (matching
  the valid-support-only semantics of scattered resampling).
  """
  assert coord_map.shape[0] == 2
  coord_map = np.asarray(coord_map, np.float32)

  tg_y, tg_x = np.mgrid[:int(dst_box.size[1]), :int(dst_box.size[0])]
  # Physical coords of target nodes -> source grid index coords.
  src_y = ((tg_y + dst_box.start[1]) * dst_stride) / src_stride - src_box.start[1]
  src_x = ((tg_x + dst_box.start[0]) * dst_stride) / src_stride - src_box.start[0]
  coords = jnp.asarray(np.stack([src_y, src_x]).astype(np.float32))

  sections = jnp.asarray(np.moveaxis(coord_map, 1, 0))
  out = jax.vmap(lambda s: _resample_section(s, coords, method))(sections)
  return np.moveaxis(np.array(out), 0, 1)


def compose_maps_fast(map1: jnp.ndarray, start1: Sequence[float],
                      stride1: StrideZYX, map2: jnp.ndarray,
                      start2: Sequence[float], stride2: StrideZYX,
                      mode: str = 'nearest') -> jnp.ndarray:
  """Composes two coordinate maps on device: result = map2 ∘ map1.

  Invalid (NaN) entries in either map propagate to the output — they are
  NOT interpolated (contract of /root/reference/map_utils.py:616-643).

  Args:
    map1/map2: [2 or 3, z, y, x] relative maps
    start1/start2: [z]yx origins (node units)
    stride1/stride2: node spacing, scalar or [z]yx
    mode: 'nearest' (edge clamp) or 'constant' (outside -> NaN)

  Returns:
    [2 or 3, z, y, x] composed map over map1's grid
  """
  assert map1.shape[0] == map2.shape[0]
  dim = map1.shape[0]
  stride1 = _as_vec(stride1, dim)
  stride2 = _as_vec(stride2, dim)
  map1 = jnp.asarray(map1, jnp.float32)
  map2 = jnp.asarray(map2, jnp.float32)
  start1 = jnp.asarray(start1, jnp.float32)
  start2 = jnp.asarray(start2, jnp.float32)

  return _compose_maps_fast_impl(map1, start1, stride1, map2, start2,
                                 stride2, mode, dim)


@functools.partial(jax.jit,
                   static_argnames=['stride1', 'stride2', 'mode', 'dim'])
def _compose_maps_fast_impl(map1, start1, stride1, map2, start2, stride2,
                            mode, dim):
  def _ref_grid(coord_map, start, stride):
    ranges = []
    for i in range(dim):
      ranges.append(
          jnp.arange(coord_map.shape[coord_map.ndim - dim + i],
                     dtype=jnp.float32) + start[-dim:][i])
    ref = jnp.meshgrid(*ranges, indexing='ij')
    return [a * b for a, b in zip(ref, stride)]  # physical coords, [z]yx

  ref1 = _ref_grid(map1, start1, stride1)
  ref2 = _ref_grid(map2, start2, stride2)

  def _compose_one(m1_sec, m2_sec):
    # Absolute query positions (in map2 grid index space), zyx order.
    q = jnp.stack([
        (ref1[dim - 1 - c] + m1_sec[c]) / stride2[dim - 1 - c]
        - start2[-dim:][dim - 1 - c]
        for c in reversed(range(dim))
    ])
    out = []
    for c in range(dim):
      absolute = m2_sec[c] + ref2[dim - 1 - c]
      vals = interp.sample(absolute, q, method='linear', mode=mode,
                           cval=np.nan)
      out.append(vals - ref1[dim - 1 - c])
    return jnp.stack(out)

  if dim == 2:
    m1 = jnp.moveaxis(map1, 1, 0)  # [z, 2, y, x]
    m2 = jnp.moveaxis(map2, 1, 0)
    out = jax.vmap(_compose_one)(m1, m2)
    return jnp.moveaxis(out, 0, 1)
  return _compose_one(map1, map2)


def compose_maps(map1: np.ndarray, box1: BoundingBox, stride1: float,
                 map2: np.ndarray, box2: BoundingBox,
                 stride2: float) -> np.ndarray:
  """Composes two 2d maps; invalid values in map2 are interpolated first.

  Equivalent to the scattered-interpolation compose
  (/root/reference/map_utils.py:549-611): map2's holes are spanned by
  interpolation, while invalid entries of map1 stay invalid.
  """
  assert map1.shape[0] == 2 and map2.shape[0] == 2
  map2_filled = fill_missing(np.asarray(map2, np.float32))
  out = compose_maps_fast(
      jnp.asarray(map1, jnp.float32),
      start1=[float(box1.start[1]), float(box1.start[0])],
      stride1=float(stride1),
      map2=jnp.asarray(map2_filled),
      start2=[float(box2.start[1]), float(box2.start[0])],
      stride2=float(stride2),
      mode='constant')
  return np.array(out)


def mask_irregular(coord_map: np.ndarray, stride: Sequence[float],
                   frac: float, max_frac: float | None = None,
                   dilation_iters: int = 1) -> np.ndarray:
  """Masks (NaNs, in place) stretched/folded parts of a [2, y, x] map."""
  assert len(coord_map.shape) == 3
  assert coord_map.shape[0] == 2
  stride = np.asarray(stride)
  if max_frac is None:
    max_frac = 2 - frac

  stride_x, stride_y = stride
  # Physical spacing between axis-adjacent nodes of the ABSOLUTE map
  # (x-channel along x, y-channel along y). A fold shows up as spacing
  # collapsing below frac*stride (or inverting); a tear/stretch as
  # spacing beyond max_frac*stride. The trailing node of each axis has
  # no forward neighbor and gets the neutral pitch, so it can only be
  # masked through the dilation of a neighbor's vote — the boundary
  # behavior pinned by the reference contract
  # (/root/reference/map_utils.py:737-786).
  ny, nx = coord_map.shape[1:]
  abs_x = coord_map[0] + np.arange(nx, dtype=np.float32) * stride_x
  abs_y = coord_map[1] + (np.arange(ny, dtype=np.float32)
                          * stride_y)[:, None]
  spacing_x = np.full((ny, nx), stride_x, np.float32)
  spacing_x[:, :-1] = abs_x[:, 1:] - abs_x[:, :-1]
  spacing_y = np.full((ny, nx), stride_y, np.float32)
  spacing_y[:-1, :] = abs_y[1:, :] - abs_y[:-1, :]

  with np.errstate(invalid='ignore'):
    bad = (spacing_x < frac * stride_x) | (spacing_y < frac * stride_y)
    bad |= ((spacing_x > max_frac * stride_x)
            | (spacing_y > max_frac * stride_y))

  for _ in range(dilation_iters):
    grown = bad.copy()
    grown[1:, :] |= bad[:-1, :]
    grown[:-1, :] |= bad[1:, :]
    grown[:, 1:] |= bad[:, :-1]
    grown[:, :-1] |= bad[:, 1:]
    grown[1:, 1:] |= bad[:-1, :-1]
    grown[:-1, :-1] |= bad[1:, 1:]
    grown[1:, :-1] |= bad[:-1, 1:]
    grown[:-1, 1:] |= bad[1:, :-1]
    bad = grown

  coord_map[0, ...][bad] = np.nan
  coord_map[1, ...][bad] = np.nan
  return bad


def make_affine_map(matrix: np.ndarray, box: BoundingBox,
                    stride: StrideZYX) -> np.ndarray:
  """Coordinate map of an affine transform ([3, 4] matrix, xyz rows)."""
  coord_map = np.array(
      _identity_map_absolute(tuple(int(s) for s in box.size[::-1]),
                             stride)[::-1])
  coord_map[0, ...] += box.start[0]
  coord_map[1, ...] += box.start[1]
  coord_map[2, ...] += box.start[2]

  affine_absolute = (
      np.dot(matrix[:3, :3], coord_map.reshape((3, -1)))
      + matrix[:, 3][:, np.newaxis]).reshape(coord_map.shape)
  return affine_absolute - coord_map
