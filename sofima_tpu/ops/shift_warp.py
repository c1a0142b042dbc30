"""Tiled shift plans: per-tile integer bases of a smooth warp.

Alignment warps are SMOOTH and BOUNDED. Split the output into tiles and
each tile's displacement field is an integer base shift (the rounded
midpoint of the tile's displacement hull) plus a small residual. The
plans here compute those bases and the residual bounds from the (tiny)
map-node displacement arrays: exact hulls, because linear densification
is a convex combination of node values (plus linear edge extrapolation,
covered by extending the node grids).

The device renders (pipeline.stack_align, pipeline.montage and the
masked flow transport) sample through the gather sampler
(`ops.interp.sample`); they run `tiled_plan_device` on the solved map to
check it against their static displacement envelope and report an
`overflow` flag when a tile leaves it. `tiled_shift_plan` is the host
twin of that plan.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Output tile of the plans: smaller tiles see more of the local
# displacement structure -> a tighter residual envelope, at more tiles.
TILE_SHAPE = (128, 256)


# Sentinel residual bounds for tiles with no finite displacement node
# (lo > hi: an empty residual range).
_EMPTY_LO = 2**20
_EMPTY_HI = -(2**20)


def _required_ext(node_out_y, node_out_x, out_shape,
                  min_ext: int = 2) -> int:
  """Extrapolated nodes per edge needed to cover the output extent.

  The hull/bounds math in this module is exact only while every output
  pixel lies within the (extended) node grid; an output box overhanging
  the map by more than `ext` node spacings would be bounded by stale
  edge values (ADVICE r2: silently under-estimated bounds). Grow the
  extension to the actual overhang instead of assuming 2.
  """
  ext = min_ext
  for pos, extent in ((np.asarray(node_out_y, np.float64), out_shape[0]),
                      (np.asarray(node_out_x, np.float64), out_shape[1])):
    if len(pos) < 2:
      continue
    s0 = max(abs(float(pos[1] - pos[0])), 1e-9)
    s1 = max(abs(float(pos[-1] - pos[-2])), 1e-9)
    over_lo = max(0.0, float(pos[0]) - 0.0) / s0
    over_hi = max(0.0, (extent - 1) - float(pos[-1])) / s1
    ext = max(ext, int(np.ceil(over_lo)), int(np.ceil(over_hi)))
  return ext


def tiled_shift_plan(
    disp_y: np.ndarray,
    disp_x: np.ndarray,
    node_out_y: np.ndarray,
    node_out_x: np.ndarray,
    out_shape: tuple[int, int],
    tile: tuple[int, int] | None = None,
    pad: float = 1.0,
    bucket: int = 4,
):
  """Host-side tiled shift plan (the twin of `tiled_plan_device`).

  Splits the output into `tile`-sized tiles and derives, per tile, an
  integer base displacement (the rounded midpoint of the nodewise
  displacement hull over the tile). What remains is the RESIDUAL
  displacement, whose range is set by the local variation of the warp —
  independent of its global magnitude.

  Args:
    disp_y/disp_x: [z, my, mx] displacement at map nodes (map value minus
      the node's own position, output-pixel space)
    node_out_y: [my] node y positions in output-pixel coordinates
    node_out_x: [mx] node x positions in output-pixel coordinates
    out_shape: (oy, ox) output size in pixels
    tile: (tile_y, tile_x) output tile shape
    pad: safety margin added to the residual bounds (edge extrapolation
      of the map densification)
    bucket: residual bounds are rounded outward to multiples of this

  Returns:
    None when no node is finite; otherwise a dict with
      bases: int32 [z, nty, ntx, 2] per-tile (y, x) base displacements
      residual_bounds: (ry_lo, ry_hi, rx_lo, rx_hi) static ints
      base_bounds: (by_lo, by_hi, bx_lo, bx_hi) static ints (bucketed to
        64) bounding every base
      tile_bounds: int32 [z, nty, ntx, 4] per-tile residual bounds
        (y_lo, y_hi, x_lo, x_hi); a strict subset of residual_bounds
      tile: the tile shape actually used
  """
  oy, ox = int(out_shape[0]), int(out_shape[1])
  ty, tx = tile if tile is not None else TILE_SHAPE
  nty = -(-oy // ty)
  ntx = -(-ox // tx)
  z = disp_y.shape[0]

  # Extend the node grids by linearly-extrapolated nodes (the dense map
  # extrapolates the same way past the last node), so the per-tile hulls
  # stay exact bounds without a wide safety pad. Between nodes the dense
  # displacement is a bilinear CONVEX combination of node values, so the
  # (extended) node hull bounds it tightly. The extension count must
  # cover the worst overhang of the output box past the node grid, or the
  # extrapolated displacement there escapes the hull.
  ext = _required_ext(node_out_y, node_out_x, out_shape)

  def extend(d, axis):
    if d.shape[axis] < 2:
      return d
    first = np.take(d, [0], axis=axis)
    second = np.take(d, [1], axis=axis)
    last = np.take(d, [-1], axis=axis)
    prev = np.take(d, [-2], axis=axis)
    lo = [first + (k + 1) * (first - second) for k in range(ext)][::-1]
    hi = [last + (k + 1) * (last - prev) for k in range(ext)]
    return np.concatenate(lo + [d] + hi, axis=axis)

  def extend_pos(p):
    if len(p) < 2:
      return p
    s0 = p[1] - p[0]
    s1 = p[-1] - p[-2]
    lo = [p[0] - (k + 1) * s0 for k in range(ext)][::-1]
    hi = [p[-1] + (k + 1) * s1 for k in range(ext)]
    return np.concatenate([lo, p, hi])

  disp_y = extend(extend(np.asarray(disp_y, np.float64), 1), 2)
  disp_x = extend(extend(np.asarray(disp_x, np.float64), 1), 2)
  node_out_y = extend_pos(np.asarray(node_out_y, np.float64))
  node_out_x = extend_pos(np.asarray(node_out_x, np.float64))

  def axis_ranges(node_pos: np.ndarray, n_tiles: int, t: int):
    m = len(node_pos)
    ranges = []
    for i in range(n_tiles):
      a, b = i * t, (i + 1) * t
      i0 = np.searchsorted(node_pos, a, side='right') - 1
      i1 = np.searchsorted(node_pos, b - 1, side='left')
      ranges.append((max(i0 - 1, 0), min(i1 + 1, m - 1)))
    return ranges

  yr = axis_ranges(np.asarray(node_out_y, np.float64), nty, ty)
  xr = axis_ranges(np.asarray(node_out_x, np.float64), ntx, tx)

  def pool(disp):
    with np.errstate(all='ignore'):
      rows_min = np.stack(
          [np.nanmin(disp[:, i0:i1 + 1, :], axis=1) for i0, i1 in yr], axis=1)
      rows_max = np.stack(
          [np.nanmax(disp[:, i0:i1 + 1, :], axis=1) for i0, i1 in yr], axis=1)
      tmin = np.stack(
          [np.nanmin(rows_min[:, :, j0:j1 + 1], axis=2) for j0, j1 in xr],
          axis=2)
      tmax = np.stack(
          [np.nanmax(rows_max[:, :, j0:j1 + 1], axis=2) for j0, j1 in xr],
          axis=2)
    return tmin, tmax  # [z, nty, ntx]

  ymin, ymax = pool(np.asarray(disp_y, np.float64))
  xmin, xmax = pool(np.asarray(disp_x, np.float64))
  if not (np.isfinite(ymin).any() and np.isfinite(xmin).any()):
    return None

  def bases_and_residual(tmin, tmax):
    with np.errstate(all='ignore'):
      base = np.rint((tmin + tmax) / 2.0)
    valid = np.isfinite(base)
    base = np.where(valid, base, 0.0)
    if not valid.any():
      return base.astype(np.int32), 0, 0
    r_lo = np.nanmin(np.where(valid, tmin - base, np.nan)) - pad
    r_hi = np.nanmax(np.where(valid, tmax - base, np.nan)) + pad
    r_lo = int(np.floor(r_lo / bucket) * bucket)
    r_hi = int(np.ceil(r_hi / bucket) * bucket)
    return base.astype(np.int32), r_lo, r_hi

  base_y, ry_lo, ry_hi = bases_and_residual(ymin, ymax)
  base_x, rx_lo, rx_hi = bases_and_residual(xmin, xmax)

  def bb(base):
    lo = int(np.floor(base.min() / 64.0) * 64)
    hi = int(np.ceil(base.max() / 64.0) * 64)
    return lo, hi

  by_lo, by_hi = bb(base_y)
  bx_lo, bx_hi = bb(base_x)
  bases = np.stack([base_y, base_x], axis=-1).astype(np.int32)
  assert bases.shape == (z, nty, ntx, 2)

  def tile_lohi(tmin, tmax, base):
    with np.errstate(all='ignore'):
      lo = np.floor(tmin - base - pad)
      hi = np.ceil(tmax - base + pad)
    valid = np.isfinite(lo) & np.isfinite(hi)
    return (np.where(valid, lo, _EMPTY_LO).astype(np.int32),
            np.where(valid, hi, _EMPTY_HI).astype(np.int32))

  ylo, yhi = tile_lohi(ymin, ymax, base_y)
  xlo, xhi = tile_lohi(xmin, xmax, base_x)
  tile_bounds = np.stack([ylo, yhi, xlo, xhi], axis=-1)
  return dict(
      bases=bases,
      residual_bounds=(ry_lo, ry_hi, rx_lo, rx_hi),
      base_bounds=(by_lo, by_hi, bx_lo, bx_hi),
      tile_bounds=tile_bounds,
      tile=(ty, tx),
  )


def tiled_plan_device(
    disp_y: jnp.ndarray,
    disp_x: jnp.ndarray,
    node_out_y: np.ndarray,
    node_out_x: np.ndarray,
    out_shape: tuple[int, int],
    residual_bounds: tuple[int, int, int, int],
    base_bounds: tuple[int, int, int, int],
    tile: tuple[int, int] | None = None,
    pad: float = 1.0,
):
  """Device-resident tiled shift plan: no map d2h round trip.

  The host plan (tiled_shift_plan) needs the coordinate map as numpy; in
  a device-resident pipeline, fetching even a small map stalls the
  device. This twin keeps the DATA on device: node positions and tile
  geometry are static (host numpy), while the per-tile hulls, bases and
  bounds are computed with XLA ops on the device map. The envelope
  (residual_bounds/base_bounds) must be supplied statically; the
  returned `overflow` scalar reports whether any finite tile exceeded
  it.

  Args:
    disp_y/disp_x: [z, my, mx] device displacement-at-node arrays
    node_out_y/node_out_x: static node positions in output pixels
    out_shape: (oy, ox) output size
    residual_bounds: static residual envelope
    base_bounds: static bounds every (clamped) base must respect
    tile: output tile shape
    pad: densification safety margin

  Returns:
    dict with device `bases` [z, nty, ntx, 2] int32, `tile_bounds`
    [z, nty, ntx, 4] int32, `overflow` bool scalar, plus the static
    residual_bounds/base_bounds/tile entries (same contract as
    tiled_shift_plan).
  """
  oy, ox = int(out_shape[0]), int(out_shape[1])
  ty, tx = tile if tile is not None else TILE_SHAPE
  nty = -(-oy // ty)
  ntx = -(-ox // tx)
  z = disp_y.shape[0]
  ext = _required_ext(node_out_y, node_out_x, out_shape)

  def extend_j(d, axis):
    if d.shape[axis] < 2:
      return d
    first = jax.lax.slice_in_dim(d, 0, 1, axis=axis)
    second = jax.lax.slice_in_dim(d, 1, 2, axis=axis)
    last = jax.lax.slice_in_dim(d, d.shape[axis] - 1, d.shape[axis],
                                axis=axis)
    prev = jax.lax.slice_in_dim(d, d.shape[axis] - 2, d.shape[axis] - 1,
                                axis=axis)
    lo = [first + (k + 1) * (first - second) for k in range(ext)][::-1]
    hi = [last + (k + 1) * (last - prev) for k in range(ext)]
    return jnp.concatenate(lo + [d] + hi, axis=axis)

  def extend_pos(p):
    if len(p) < 2:
      return np.asarray(p, np.float64)
    p = np.asarray(p, np.float64)
    s0 = p[1] - p[0]
    s1 = p[-1] - p[-2]
    lo = [p[0] - (k + 1) * s0 for k in range(ext)][::-1]
    hi = [p[-1] + (k + 1) * s1 for k in range(ext)]
    return np.concatenate([lo, p, hi])

  dY = extend_j(extend_j(jnp.asarray(disp_y, jnp.float32), 1), 2)
  dX = extend_j(extend_j(jnp.asarray(disp_x, jnp.float32), 1), 2)
  pos_y = extend_pos(node_out_y)
  pos_x = extend_pos(node_out_x)

  def windows(node_pos, n_tiles, t):
    """Static per-tile node-index windows (equal width, clamped)."""
    m = len(node_pos)
    lo_hi = []
    for i in range(n_tiles):
      a, b = i * t, (i + 1) * t
      i0 = np.searchsorted(node_pos, a, side='right') - 1
      i1 = np.searchsorted(node_pos, b - 1, side='left')
      lo_hi.append((max(i0 - 1, 0), min(i1 + 1, m - 1)))
    width = max(i1 - i0 + 1 for i0, i1 in lo_hi)
    idx = np.stack([np.minimum(i0 + np.arange(width), i1)
                    for i0, i1 in lo_hi])
    return idx  # [n_tiles, width]

  idx_y = windows(pos_y, nty, ty)
  idx_x = windows(pos_x, ntx, tx)

  def pool(d):
    rows = d[:, idx_y, :]                       # [z, nty, wy, mx]
    rmin = jnp.nanmin(rows, axis=2)
    rmax = jnp.nanmax(rows, axis=2)
    cmin = jnp.nanmin(rmin[:, :, idx_x], axis=3)  # [z, nty, ntx]
    cmax = jnp.nanmax(rmax[:, :, idx_x], axis=3)
    return cmin, cmax

  ymin, ymax = pool(dY)
  xmin, xmax = pool(dX)

  ry_lo, ry_hi, rx_lo, rx_hi = residual_bounds
  by_lo, by_hi, bx_lo, bx_hi = base_bounds

  def bases_bounds(tmin, tmax, b_lo, b_hi, r_lo, r_hi):
    mid = jnp.rint((tmin + tmax) * 0.5)
    valid = jnp.isfinite(mid)
    base = jnp.clip(jnp.where(valid, mid, 0.0), b_lo, b_hi)
    lo = jnp.floor(tmin - base - pad)
    hi = jnp.ceil(tmax - base + pad)
    over = valid & ((lo < r_lo) | (hi > r_hi))
    lo = jnp.where(valid, lo, _EMPTY_LO).astype(jnp.int32)
    hi = jnp.where(valid, hi, _EMPTY_HI).astype(jnp.int32)
    return base.astype(jnp.int32), lo, hi, jnp.any(over)

  base_y, ylo, yhi, oy_f = bases_bounds(ymin, ymax, by_lo, by_hi,
                                        ry_lo, ry_hi)
  base_x, xlo, xhi, ox_f = bases_bounds(xmin, xmax, bx_lo, bx_hi,
                                        rx_lo, rx_hi)
  bases = jnp.stack([base_y, base_x], axis=-1)
  tile_bounds = jnp.stack([ylo, yhi, xlo, xhi], axis=-1)
  assert bases.shape == (z, nty, ntx, 2)
  return dict(
      bases=bases,
      tile_bounds=tile_bounds,
      overflow=jnp.logical_or(oy_f, ox_f),
      residual_bounds=(ry_lo, ry_hi, rx_lo, rx_hi),
      base_bounds=(by_lo, by_hi, bx_lo, bx_hi),
      tile=(ty, tx),
  )
