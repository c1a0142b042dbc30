"""Device-resident 3d tile stitching (BASELINE scenario 4, LICONN).

The reference's volumetric stitching chain (SURVEY.md §3.5;
/root/reference/stitch_elastic.py:285-453 + processor/warp.py
StitchAndRender3dTiles) is host-orchestrated: the renderer inverts each
tile's mesh on host arrays and streams every warped work box back over
the host link. This module keeps the whole chain in device memory:

  1. FINE    per-pair 3d overlap flow (stitch_elastic.compute_flow_map3d
             circular strip path — tiles upload once, tiny grids return)
  2. SOLVE   joint 26-neighbor elastic solve of all tile meshes
             (mesh.relax_mesh + vmapped compute_target_mesh prev_fn)
  3. RENDER  per tile: fixed-point/Newton 3d map inversion + harmonic
             fill + trilinear gather warp of the tile, blend
             weights evaluated in closed form at the source coords
             (the 2d EDT of a rectangular margin mask is the min of
             axis distances), then weighted accumulation into a device
             canvas (`render_stitched_3d`). Only tiny statistics ever
             cross the device->host link.

The host processor (processor.warp.StitchAndRender3dTiles) remains the
reference-parity path; this is its device twin (same distance-weighted
blend, same margin semantics via the warped weight volume).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from sofima_tpu import map_utils
from sofima_tpu import mesh
from sofima_tpu import stitch_elastic
from sofima_tpu.ops import fill as fill_ops
from sofima_tpu.ops import interp
from sofima_tpu.warp import _densify_box_3d

TileXY = tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Stitch3dConfig:
  """Static configuration of the device-resident 3d stitch chain."""
  stride: tuple[int, int, int] = (16, 16, 16)
  patch_size: tuple[int, int, int] = (32, 32, 32)
  flow_batch: int = 64
  flow_mode: str = 'circular'
  # Blend margin (px removed at interior tile edges before the distance
  # transform; reference StitchAndRender3dTiles semantics).
  margin: int = 8
  # Render halo beyond the nominal tile extent, in mesh nodes.
  pad_nodes: int = 2
  # Map-inversion iterations (stitch meshes are smooth).
  invert_fp_iters: int = 16
  invert_newton_iters: int = 4
  # Joint elastic solve.
  mesh_cfg: mesh.IntegrationConfig = dataclasses.field(
      default_factory=lambda: mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(16.0, 16.0, 16.0),
          num_iters=400, max_iters=10000, stop_v_max=0.005, dt_max=100.0))


@functools.partial(
    jax.jit,
    static_argnames=['stride', 'pad_nodes', 'fp_iters', 'newton_iters'])
def _render_tile_3d(tile: jnp.ndarray, edges: jnp.ndarray,
                    resid_rel: jnp.ndarray, stride: tuple[int, int, int],
                    pad_nodes: int, fp_iters: int, newton_iters: int):
  """Warps ONE tile + its blend weights by its solved mesh, on device.

  Args:
    tile: [tz, ty, tx] tile image (float32)
    edges: [4] (y_lo, y_hi, x_lo, x_hi) blend-weight anchors: the blend
      weight at source position (sy, sx) is
      max(min(sy - y_lo, y_hi - sy, sx - x_lo, x_hi - sx), 0) — the
      CLOSED FORM of the reference's 2d EDT of the rectangular margin
      mask (inside a rectangle the nearest zero pixel is axis-aligned),
      evaluated at the warp's source coords instead of warping a
      distance image (sub-pixel-equivalent, saves the second 3d warp)
    resid_rel: [3 (x, y, z), gz, gy, gx] relative solved mesh minus the
      tile's integer mean offset (the mean is applied at paste time)
    stride: mesh node spacing (sz, sy, sx)
    pad_nodes: output halo beyond the tile extent, in nodes
    fp_iters/newton_iters: map inversion iterations

  Returns:
    (warped [oz, oy, ox], warped_dts [oz, oy, ox]) where o* = tile
    extent + 2 * pad_nodes * stride; output voxel (0, 0, 0) sits at
    tile voxel (-pad, -pad, -pad).
  """
  sz, sy, sx = int(stride[0]), int(stride[1]), int(stride[2])
  gz, gy, gx = resid_rel.shape[-3:]
  p = int(pad_nodes)
  oz_n, oy_n, ox_n = gz + 2 * p, gy + 2 * p, gx + 2 * p

  # Forward absolute map on the source node grid (tile-local px,
  # channels x, y, z per map_utils._invert_section's convention).
  node_x = jnp.arange(gx, dtype=jnp.float32) * sx
  node_y = jnp.arange(gy, dtype=jnp.float32) * sy
  node_z = jnp.arange(gz, dtype=jnp.float32) * sz
  fwd_abs = jnp.stack([
      resid_rel[0] + node_x[None, None, :],
      resid_rel[1] + node_y[None, :, None],
      resid_rel[2] + node_z[:, None, None],
  ])

  # Query grid: the expanded output nodes, tile-local px (x, y, z).
  qx = (jnp.arange(ox_n, dtype=jnp.float32) - p) * sx
  qy = (jnp.arange(oy_n, dtype=jnp.float32) - p) * sy
  qz = (jnp.arange(oz_n, dtype=jnp.float32) - p) * sz
  shape_n = (oz_n, oy_n, ox_n)
  query = jnp.stack([
      jnp.broadcast_to(qx[None, None, :], shape_n),
      jnp.broadcast_to(qy[None, :, None], shape_n),
      jnp.broadcast_to(qz[:, None, None], shape_n),
  ])

  zeros3 = jnp.zeros(3, jnp.float32)
  stride3 = jnp.asarray([sz, sy, sx], jnp.float32)
  inv_abs = map_utils._invert_section(
      fwd_abs, zeros3, query, stride3, num_iters=fp_iters,
      newton_iters=newton_iters)
  rel_inv = inv_abs - query
  valid = (jnp.isfinite(rel_inv[0]) & jnp.isfinite(rel_inv[1])
           & jnp.isfinite(rel_inv[2]))
  rel_inv = fill_ops.fill_invalid(rel_inv, valid, extrapolate=True)
  inv_abs = rel_inv + query

  # Densify to per-voxel sampling coords (tile-local px, zyx channels).
  # Output voxel v sits at tile px v - pad and at expanded-node index
  # v / stride, so sampling the expanded node grid at v * (1/stride)
  # yields the absolute tile-local source coords directly.
  out_shape = (oz_n * sz, oy_n * sy, ox_n * sx)
  src_zyx = jnp.stack([inv_abs[2], inv_abs[1], inv_abs[0]])
  zero3 = jnp.zeros(3, jnp.float32)
  dense = _densify_box_3d(
      src_zyx, zero3,
      jnp.asarray([1.0 / sz, 1.0 / sy, 1.0 / sx], jnp.float32), zero3,
      out_shape)

  warped = interp.sample(tile, dense, method='linear', mode='constant',
                         cval=0.0)

  # Analytic blend weights at the source coords (see `edges`); zeroed
  # where the sample falls outside the tile volume, mirroring the
  # warp's outside-volume zeros on the old warped-distance-image path.
  src_z, src_y, src_x = dense[0], dense[1], dense[2]
  tz = tile.shape[0]
  tyy, txx = tile.shape[1], tile.shape[2]
  wdts = jnp.minimum(
      jnp.minimum(src_y - edges[0], edges[1] - src_y),
      jnp.minimum(src_x - edges[2], edges[3] - src_x))
  inside = ((src_z > -1.0) & (src_z < tz) & (src_y > -1.0) & (src_y < tyy)
            & (src_x > -1.0) & (src_x < txx))
  warped_dts = jnp.where(inside, jnp.maximum(wdts, 0.0), 0.0)
  return warped, warped_dts


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _paste_blend(img_acc, w_acc, warped, warped_dts, z0, y0, x0):
  """Distance-weighted accumulation (reference blend semantics)."""
  start = (z0, y0, x0)
  cur_i = jax.lax.dynamic_slice(img_acc, start, warped.shape)
  cur_w = jax.lax.dynamic_slice(w_acc, start, warped.shape)
  img_acc = jax.lax.dynamic_update_slice(
      img_acc, cur_i + warped * warped_dts, start)
  w_acc = jax.lax.dynamic_update_slice(w_acc, cur_w + warped_dts, start)
  return img_acc, w_acc


def render_stitched_3d(
    tiles: dict[TileXY, jnp.ndarray],
    solved: np.ndarray,
    key_to_idx: dict[TileXY, int],
    cfg: Stitch3dConfig | None = None,
    yx_shape: tuple[int, int] | None = None,
):
  """Device-resident twin of StitchAndRender3dTiles' blended render.

  Tiles stay on the device; each tile's 3d map inversion, hole fill,
  trilinear warp (image + distance-transform weights) and weighted
  accumulation run on device. The solved meshes (tiny host arrays) are
  split into a per-tile integer mean offset — applied as the paste
  position — and a residual deformation baked into the inversion.

  Args:
    tiles: (x, y) -> [tz, ty, tx] device arrays
    solved: [3 (x, y, z), n, gz, gy, gx] solved meshes (jnp device
      array: per-tile stats are device-reduced and fetched as one tiny
      vector; np host array: reference host path)
    key_to_idx: (x, y) -> mesh index
    cfg: chain configuration
    yx_shape: tile grid shape (inferred from keys if omitted)

  Returns:
    (canvas [Z, Y, X] float32 device array — distance-weight-normalized,
     0 where no tile contributed; weight-sum [Z, Y, X] device array)
    The canvas covers [0, tz) x [0, ty*ny) x [0, tx*nx) in nominal tile
    coordinates.
  """
  cfg = cfg or Stitch3dConfig()
  any_tile = next(iter(tiles.values()))
  tz, ty, tx = (int(any_tile.shape[0]), int(any_tile.shape[1]),
                int(any_tile.shape[2]))
  if yx_shape is None:
    yx_shape = (max(y for _, y in tiles) + 1, max(x for x, _ in tiles) + 1)
  sz, sy, sx = cfg.stride

  # Integer mean offsets + residual bound. With a DEVICE `solved`, the
  # full mesh never crosses the link — one [3n+1]-float stats fetch
  # replaces the per-run mesh pull.
  offs, resids = {}, {}
  if isinstance(solved, jnp.ndarray):
    n_m = solved.shape[1]
    flat = solved.reshape(3, n_m, -1)
    means_d = jnp.round(jnp.nan_to_num(jnp.nanmean(flat, axis=-1)))
    resid_d = jnp.abs(flat - means_d[..., None])
    resid_max_d = jnp.max(
        jnp.where(jnp.isnan(resid_d), 0.0, resid_d), axis=(1, 2))  # [3] xyz
    stats = np.asarray(jnp.concatenate([means_d.reshape(-1), resid_max_d]))
    means = stats[:-3].reshape(3, n_m)
    max_resid_xyz = stats[-3:]
    for key, i in key_to_idx.items():
      if key not in tiles:
        continue
      off = means[:, i].astype(int)
      offs[key] = off
      resids[key] = (solved[:, i]
                     - jnp.asarray(off, jnp.float32)[:, None, None, None])
  else:
    max_resid_xyz = np.zeros(3)
    for key, i in key_to_idx.items():
      if key not in tiles:
        continue
      m = np.asarray(solved[:, i])  # [3, gz, gy, gx]
      off = np.round([np.nanmean(m[0]), np.nanmean(m[1]),
                      np.nanmean(m[2])]).astype(int)
      offs[key] = off
      resids[key] = (m - off[:, None, None, None]).astype(np.float32)
      if np.isfinite(resids[key]).any():
        max_resid_xyz = np.maximum(
            max_resid_xyz,
            np.nanmax(np.abs(resids[key]).reshape(3, -1), axis=-1))

  # Render halo: the largest residual + 2 px inversion slack, bucketed
  # to 4 px so repeated scenarios reuse the compile.
  bound_px = int(-(-(float(max(max_resid_xyz)) + 2.0) // 4) * 4)
  pad_nodes = max(cfg.pad_nodes, -(-bound_px // min(sz, sy, sx)) + 1)

  pad_z, pad_y, pad_x = pad_nodes * sz, pad_nodes * sy, pad_nodes * sx
  max_off = max(int(np.abs(o).max()) for o in offs.values())
  pc = -(-(max_off + max(pad_z, pad_y, pad_x) + 8) // 64) * 64
  canvas_shape = (tz + 2 * pc, ty * yx_shape[0] + 2 * pc,
                  tx * yx_shape[1] + 2 * pc)
  img_acc = jnp.zeros(canvas_shape, jnp.float32)
  w_acc = jnp.zeros(canvas_shape, jnp.float32)

  # Blend-weight anchors per tile position. The reference
  # (processor.warp.StitchAndRender3dTiles._blend_weights) computes the
  # 2d EDT of the rectangular margin mask — margin trimmed at interior
  # edges, 1 px at grid-boundary edges — and warps the distance image;
  # inside a rectangle the EDT is exactly min(axis distances to the
  # mask edges), so the kernel evaluates that closed form at the source
  # coords instead (one warp per tile instead of two).
  def blend_edges(txi, tyi):
    if cfg.margin > 0:
      x_lo = (cfg.margin if txi > 0 else 0) - 1.0
      x_hi = float(tx - (cfg.margin if txi < yx_shape[1] - 1 else 1))
      y_lo = (cfg.margin if tyi > 0 else 0) - 1.0
      y_hi = float(ty - (cfg.margin if tyi < yx_shape[0] - 1 else 1))
    else:
      x_lo, x_hi, y_lo, y_hi = -1.0, float(tx), -1.0, float(ty)
    return jnp.asarray([y_lo, y_hi, x_lo, x_hi], jnp.float32)

  for key, i in key_to_idx.items():
    tile = tiles.get(key)
    if tile is None:
      continue
    warped, warped_dts = _render_tile_3d(
        jnp.asarray(tile, jnp.float32), blend_edges(key[0], key[1]),
        jnp.asarray(resids[key]), (sz, sy, sx), pad_nodes,
        cfg.invert_fp_iters, cfg.invert_newton_iters)
    z0 = int(offs[key][2]) - pad_z + pc
    y0 = ty * key[1] + int(offs[key][1]) - pad_y + pc
    x0 = tx * key[0] + int(offs[key][0]) - pad_x + pc
    if (min(z0, y0, x0) < 0 or z0 + warped.shape[0] > canvas_shape[0]
        or y0 + warped.shape[1] > canvas_shape[1]
        or x0 + warped.shape[2] > canvas_shape[2]):
      raise ValueError(f'tile {key} paste box out of canvas: {offs[key]}')
    img_acc, w_acc = _paste_blend(img_acc, w_acc, warped, warped_dts,
                                  np.int32(z0), np.int32(y0), np.int32(x0))

  sl = (np.s_[pc:pc + tz], np.s_[pc:pc + ty * yx_shape[0]],
        np.s_[pc:pc + tx * yx_shape[1]])
  img_acc, w_acc = img_acc[sl], w_acc[sl]
  canvas = jnp.where(w_acc > 0, img_acc / jnp.maximum(w_acc, 1e-20), 0.0)
  return canvas, w_acc


def stitch_and_render_3d(tiles: dict[TileXY, np.ndarray],
                         offset_x: np.ndarray, offset_y: np.ndarray,
                         coarse: np.ndarray,
                         cfg: Stitch3dConfig | None = None,
                         device_tiles: dict[TileXY, jnp.ndarray] | None
                         = None):
  """End-to-end 3d stitch: fine flow -> joint solve -> blended render.

  Each tile is uploaded ONCE (or reused from `device_tiles` when the
  caller already holds them on the device, e.g. a timed benchmark
  loop); the fine-flow phase slices overlap strips on device, the solve
  and render stay device-resident, and only tiny statistics cross the
  link (per-run link traffic is O(mesh nodes), not O(voxels)).

  Args:
    tiles: (x, y) -> [tz, ty, tx] host arrays
    offset_x/offset_y: [3, 1, ny, nx] coarse XYZ offsets between x- and
      y-adjacent tiles (NaN for absent pairs; stitch_rigid conventions)
    coarse: [3, 1, ny, nx] per-tile coarse positions
    cfg: chain configuration
    device_tiles: optional (x, y) -> [tz, ty, tx] device copies

  Returns a dict: canvas + weight sum (device arrays), solved meshes,
  key_to_idx, solve step count.
  """
  cfg = cfg or Stitch3dConfig()
  any_tile = next(iter(tiles.values()))
  tz, ty, tx = (int(any_tile.shape[0]), int(any_tile.shape[1]),
                int(any_tile.shape[2]))
  yx_shape = (offset_x.shape[-2], offset_x.shape[-1])

  # One upload per tile; the flow phase then slices overlap strips ON
  # DEVICE (compute_flow_map3d passes jnp slices straight to the strip
  # kernel), so no bulk data crosses the link per run.
  if device_tiles is None:
    device_tiles = {k: jnp.asarray(np.asarray(t), jnp.float32)
                    for k, t in tiles.items()}

  class _TileView:
    """[1, z, y, x] array-like over a tile, as compute_flow_map3d
    expects; holds a device array so slices stay in HBM."""

    def __init__(self, t):
      self._t = t
      self.shape = (1,) + tuple(int(s) for s in t.shape)

    def __getitem__(self, sel):
      return self._t[None][sel]

  tile_views = {k: _TileView(device_tiles[k]) for k in tiles}
  flows_x, off_x = stitch_elastic.compute_flow_map3d(
      tile_views, tile_shape=(tx, ty, tz), offset_map=offset_x, axis=0,
      patch_size=cfg.patch_size, stride=cfg.stride,
      batch_size=cfg.flow_batch, flow_mode=cfg.flow_mode)
  flows_y, off_y = stitch_elastic.compute_flow_map3d(
      tile_views, tile_shape=(tx, ty, tz), offset_map=offset_y, axis=1,
      patch_size=cfg.patch_size, stride=cfg.stride,
      batch_size=cfg.flow_batch, flow_mode=cfg.flow_mode)

  fx_a, fy_a, x0, nbors, key_to_idx = stitch_elastic.aggregate_arrays(
      (offset_x[:, 0], flows_x, off_x), (offset_y[:, 0], flows_y, off_y),
      list(tiles.keys()), coarse[:, 0], cfg.stride,
      tile_shape=(tz, ty, tx))
  fx_j, fy_j = jnp.asarray(fx_a), jnp.asarray(fy_a)
  nbors_j = jnp.asarray(nbors)

  def prev_fn(x):
    tgt = jax.vmap(functools.partial(
        stitch_elastic.compute_target_mesh, x=x, fx=fx_j, fy=fy_j,
        stride=cfg.stride))(nbors_j)
    return jnp.moveaxis(tgt, 0, 1)

  solved, _, steps = mesh.relax_mesh(jnp.asarray(x0), None, cfg.mesh_cfg,
                                     prev_fn=prev_fn,
                                     mesh_force=mesh.elastic_mesh_3d)

  canvas, w_acc = render_stitched_3d(device_tiles, solved, key_to_idx,
                                     cfg, yx_shape=yx_shape)
  return dict(canvas=canvas, weights=w_acc, solved=solved,
              key_to_idx=key_to_idx, solve_steps=int(steps))
