"""Device-resident 2d tile montage (BASELINE scenario 2).

The reference's montage chain (SURVEY.md §3.4; em_stitching notebook:
/root/reference/stitch_rigid.py, /root/reference/stitch_elastic.py,
/root/reference/warp.py:338-538) is host-orchestrated: every coarse
probe, fine-flow crop and rendered tile crosses the host<->device link.
This module keeps the tiles resident in device memory for the whole
chain:

  1. COARSE  batched full-strip masked xcorr over all tile pairs
             (stitch_rigid.compute_coarse_offsets_batched): 4 device
             dispatches, one tiny stats fetch each.
  2. PLACE   optimize_coarse_mesh (per-tile nodes; tiny).
  3. FINE    per-pair overlap flow on device-sliced strips
             (stitch_elastic.compute_flow_map with a circular/DFT
             flow_mode): one dispatch per pair, small grid fetch.
  4. SOLVE   joint elastic solve of all tile meshes (mesh.relax_mesh +
             vmap(compute_target_mesh) prev_fn) — already device-native.
  5. RENDER  per tile: fixed-point/Newton map inversion + harmonic fill
             + Lanczos gather warp + on-device canvas paste
             (`render_tiles_device`). The canvas never leaves the
             device; the caller fetches it (or a quality statistic) once.

The host render (warp.render_tiles) remains the reference-parity path;
`render_tiles_device` is its device twin (same margin/overwrite
semantics, analytic margin mask instead of a warped indicator image).
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
from sofima_tpu import stitch_rigid
from sofima_tpu.ops import fill as fill_ops
from sofima_tpu.ops import interp as interp_ops
from sofima_tpu.ops import shift_warp

TileXY = tuple[int, int]


@dataclasses.dataclass(frozen=True)
class MontageConfig:
  """Static configuration of the device-resident 2d montage chain."""
  stride: int = 40
  patch_size: int = 160
  # Coarse whole-overlap search grid (stitch_rigid contract).
  coarse_overlaps: tuple[int, ...] = (360, 440)
  min_range: tuple[float, ...] = (10, 100, 0)
  min_overlap: int = 200
  filter_size: int = 10
  # Fine-flow correlation backend (see flow_field.flow_field `mode`).
  flow_mode: str = 'circular_dft_bf16'
  flow_batch: int = 256
  # Render.
  margin: int = 16
  method: str = 'lanczos'
  # Residual envelope around each render tile's integer base (px; the
  # per-tile deformation variation after the solve); exceeding it sets
  # the render's overflow flag.
  residual: int = 8
  # Map-inversion iterations (montage meshes are smooth).
  invert_fp_iters: int = 16
  invert_newton_iters: int = 4
  # Render halo beyond the nominal tile extent, in mesh nodes. Must
  # cover the tile's residual (mean-removed) deformation; the actual
  # bound is checked on the host against the solved mesh and bumped in
  # buckets of 4 nodes, so this is only the starting point.
  pad_nodes: int = 8
  # Joint elastic solve (reference defaults: stitch_elastic usage).
  mesh_cfg: mesh.IntegrationConfig = dataclasses.field(
      default_factory=lambda: mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0, 40.0),
          num_iters=1000, max_iters=20000, stop_v_max=0.005,
          dt_max=100.0))


@functools.partial(
    jax.jit,
    static_argnames=['stride', 'margin', 'pad_nodes', 'bound_nodes',
                     'residual', 'method', 'fp_iters', 'newton_iters'])
def _render_tile_device(tile: jnp.ndarray, resid_rel: jnp.ndarray,
                        stride: int, margin: int, pad_nodes: int,
                        bound_nodes: int, residual: int, method: str,
                        fp_iters: int, newton_iters: int):
  """Warps ONE tile by its (mean-removed) solved mesh, on device.

  Args:
    tile: [ty, tx] tile image (float32)
    resid_rel: [2 (x, y), gy, gx] relative solved mesh minus the tile's
      integer mean offset (the mean is applied at paste time)
    stride: mesh node spacing
    margin: tile-edge pixels excluded from rendering (reference
      render_tiles margin semantics)
    pad_nodes: output halo beyond the tile extent, in nodes
    bound_nodes: static bound on |resid_rel| in nodes (inversion
      shift lattice + render envelope)
    residual: render residual envelope around per-tile bases (px;
      checked, not a limit on the sampled displacement)
    method: interpolation kernel
    fp_iters/newton_iters: map inversion iterations

  Returns:
    (warped [oy, ox] float32, mask [oy, ox] bool, overflow bool scalar)
    where oy/ox = tile extent + 2 * pad_nodes * stride; output pixel
    (0, 0) sits at tile pixel (-pad, -pad).
  """
  s = int(stride)
  ty, tx = tile.shape
  gy, gx = resid_rel.shape[-2:]
  p = int(pad_nodes)
  oy_n, ox_n = gy + 2 * p, gx + 2 * p


  # Forward absolute map on the source node grid (tile-local px).
  node_x = jnp.arange(gx, dtype=jnp.float32) * s
  node_y = jnp.arange(gy, dtype=jnp.float32) * s
  fwd_abs = jnp.stack([resid_rel[0] + node_x[None, :],
                       resid_rel[1] + node_y[:, None]])

  # Query grid: the expanded output nodes, tile-local px.
  qx = (jnp.arange(ox_n, dtype=jnp.float32) - p) * s
  qy = (jnp.arange(oy_n, dtype=jnp.float32) - p) * s
  query = jnp.stack([jnp.broadcast_to(qx[None, :], (oy_n, ox_n)),
                     jnp.broadcast_to(qy[:, None], (oy_n, ox_n))])

  zeros2 = jnp.zeros(2, jnp.float32)
  stride2 = jnp.full((2,), float(s), jnp.float32)
  inv_abs = map_utils._invert_section(
      fwd_abs, zeros2, query, stride2, num_iters=fp_iters,
      newton_iters=newton_iters, shift_bound=bound_nodes + 1,
      shift_origin=(-p, -p))
  rel_inv = inv_abs - query
  valid = jnp.isfinite(rel_inv[0]) & jnp.isfinite(rel_inv[1])
  rel_inv = fill_ops.fill_invalid(rel_inv, valid, extrapolate=True)
  inv_abs = rel_inv + query

  # Densify to per-pixel sampling coords (tile-local px, (y, x)).
  out_shape = (oy_n * s, ox_n * s)
  dense = interp_ops.upsample_map_linear(
      jnp.stack([inv_abs[1], inv_abs[0]]), s, (0, 0), out_shape)

  # Tiled shift plan: output-pixel positions are tile-local + pad.
  node_out = np.arange(max(oy_n, ox_n), dtype=np.float64) * s
  bb = bound_nodes * s + s
  env_r = (-residual, residual, -residual, residual)
  env_b = (-bb, bb, -bb, bb)
  dplan = shift_warp.tiled_plan_device(
      rel_inv[1][None], rel_inv[0][None], node_out[:oy_n], node_out[:ox_n],
      out_shape, env_r, env_b)

  warped = interp_ops.sample(tile, dense, method=method, mode='constant',
                             cval=0.0)

  # Analytic margin mask: the reference warps a 0/1 indicator image of
  # mask[margin:-(margin+1), margin:-(margin+1)] alongside the tile and
  # keeps nonzero pixels; here validity is evaluated directly on the
  # sampling positions (sub-pixel-equivalent, no second warp).
  in_y = (dense[0] >= margin) & (dense[0] <= ty - 2 - margin)
  in_x = (dense[1] >= margin) & (dense[1] <= tx - 2 - margin)
  mask = in_y & in_x

  return warped, mask, dplan['overflow']


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _paste(canvas: jnp.ndarray, cmask: jnp.ndarray, warped: jnp.ndarray,
           wmask: jnp.ndarray, y0, x0):
  """Pastes one warped tile; reference overwrite semantics
  (warp.render_tiles: mask |= wmask; img[wmask & warped > 0] = warped).
  """
  start = (y0, x0)
  cur = jax.lax.dynamic_slice(canvas, start, warped.shape)
  curm = jax.lax.dynamic_slice(cmask, start, warped.shape)
  write = wmask & (warped > 0)
  canvas = jax.lax.dynamic_update_slice(
      canvas, jnp.where(write, warped, cur), start)
  cmask = jax.lax.dynamic_update_slice(cmask, curm | wmask, start)
  return canvas, cmask


def render_tiles_device(
    tiles: dict[TileXY, jnp.ndarray],
    coord_maps: dict[TileXY, np.ndarray],
    stride: int = 20,
    margin: int = 50,
    cfg: MontageConfig | None = None,
    width: int | None = None,
    height: int | None = None,
):
  """Device-resident twin of `warp.render_tiles`.

  Tiles stay on the device; each tile's map inversion, hole fill,
  Lanczos warp and canvas paste run on device, and the canvas is returned as a
  device array (fetch it once, or compute statistics on device).

  The solved maps (`coord_maps`, tiny [2, 1, gy, gx] host arrays) are
  split into a per-tile integer mean offset — applied as the paste
  position, keeping the static displacement envelope small — and a
  residual deformation baked into the inversion. The envelope is
  sized from the actual residuals in buckets of 4 nodes, so a scenario
  compiles the per-tile program once (twice across bucket growth).

  Returns:
    (canvas [height, width] float32 device array,
     mask [height, width] bool device array,
     overflow: True if any tile exceeded its static render envelope)
  """
  cfg = cfg or MontageConfig()
  any_tile = next(iter(tiles.values()))
  ty, tx = int(any_tile.shape[0]), int(any_tile.shape[1])
  if width is None or height is None:
    max_x = max(x for x, _ in tiles)
    max_y = max(y for _, y in tiles)
    height, width = ty * (max_y + 1), tx * (max_x + 1)
  s = int(stride)

  # Integer mean offsets + residual bound. Device coord_maps (jnp) are
  # stats-reduced ON DEVICE and fetched as one [2n+1]-float vector —
  # the solved meshes never cross the link per run; host maps keep the
  # reference numpy path.
  offs, resids = {}, {}
  keys_cm = list(coord_maps.keys())
  if keys_cm and isinstance(coord_maps[keys_cm[0]], jnp.ndarray):
    stacked = jnp.stack([coord_maps[k][:, 0] for k in keys_cm], axis=1)
    flat = stacked.reshape(2, len(keys_cm), -1)
    means_d = jnp.round(jnp.nan_to_num(jnp.nanmean(flat, axis=-1)))
    resid_d = jnp.abs(flat - means_d[..., None])
    rmax_d = jnp.nanmax(jnp.where(jnp.isnan(resid_d), 0.0, resid_d))
    stats = np.asarray(
        jnp.concatenate([means_d.reshape(-1), rmax_d[None]]))
    means = stats[:-1].reshape(2, len(keys_cm))
    max_resid = float(stats[-1])
    for j, key in enumerate(keys_cm):
      off = means[:, j].astype(int)
      offs[key] = off
      resids[key] = stacked[:, j] - jnp.asarray(off, jnp.float32)[:, None,
                                                                  None]
  else:
    max_resid = 0.0
    for key, cmap in coord_maps.items():
      m = np.asarray(cmap)[:, 0]  # [2, gy, gx]
      off = np.round([np.nanmean(m[0]), np.nanmean(m[1])]).astype(int)
      offs[key] = off
      resids[key] = m - off[:, None, None]
      if np.isfinite(resids[key]).any():
        max_resid = max(max_resid, float(np.nanmax(np.abs(resids[key]))))

  bound_nodes = int(-(-(max_resid + 2.0) // s)) + 1
  bound_nodes = -(-bound_nodes // 4) * 4  # bucket: stable compiles
  pad_nodes = max(cfg.pad_nodes, bound_nodes)
  pad_px = pad_nodes * s

  # Canvas with a halo covering paste offsets + the render pad.
  pc = int(-(-(max(abs(o).max() for o in offs.values()) + pad_px + s)
             // 256) * 256) if offs else pad_px
  canvas = jnp.zeros((height + 2 * pc, width + 2 * pc), jnp.float32)
  cmask = jnp.zeros(canvas.shape, bool)

  overflow = jnp.asarray(False)
  for key, cmap in coord_maps.items():
    tile = tiles.get(key)
    if tile is None:
      continue
    warped, wmask, ovf = _render_tile_device(
        jnp.asarray(tile, jnp.float32), jnp.asarray(resids[key],
                                                    jnp.float32),
        s, int(margin), pad_nodes, bound_nodes, cfg.residual, cfg.method,
        cfg.invert_fp_iters, cfg.invert_newton_iters)
    y0 = ty * key[1] + int(offs[key][1]) - pad_px + pc
    x0 = tx * key[0] + int(offs[key][0]) - pad_px + pc
    if y0 < 0 or x0 < 0 or (y0 + warped.shape[0] > canvas.shape[0]
                            or x0 + warped.shape[1] > canvas.shape[1]):
      raise ValueError(
          f'tile {key} paste box out of canvas; offset {offs[key]}')
    canvas, cmask = _paste(canvas, cmask, warped, wmask, np.int32(y0),
                           np.int32(x0))
    overflow = jnp.logical_or(overflow, ovf)  # stays on device: no sync

  return (canvas[pc:pc + height, pc:pc + width],
          cmask[pc:pc + height, pc:pc + width], overflow)


def montage_align_2d(tiles: dict[TileXY, jnp.ndarray],
                     yx_shape: tuple[int, int],
                     cfg: MontageConfig | None = None):
  """End-to-end 2d montage: coarse -> place -> fine -> solve -> render.

  `tiles` values should be device arrays (jnp) — every stage then slices
  and correlates on the device, and only small statistics/meshes cross
  the host link.

  Returns a dict: canvas + mask (device arrays), solved mesh,
  key_to_idx, coarse offsets, render overflow flag.
  """
  cfg = cfg or MontageConfig()
  s = cfg.stride
  stride_t = (s, s)
  any_tile = next(iter(tiles.values()))
  tile_shape = (int(any_tile.shape[0]), int(any_tile.shape[1]))

  ov = tuple(cfg.coarse_overlaps)
  cx, cy = stitch_rigid.compute_coarse_offsets_batched(
      yx_shape, tiles, overlaps_xy=(ov, ov), min_range=cfg.min_range,
      min_overlap=cfg.min_overlap, filter_size=cfg.filter_size)
  cx = stitch_rigid.interpolate_missing_offsets(cx, axis=-1)
  cy = stitch_rigid.interpolate_missing_offsets(cy, axis=-2)
  coarse = stitch_rigid.optimize_coarse_mesh(cx, cy)

  fine_x, off_x = stitch_elastic.compute_flow_map(
      tiles, cx[:, 0], axis=0, patch_size=(cfg.patch_size, cfg.patch_size),
      stride=stride_t, batch_size=cfg.flow_batch, flow_mode=cfg.flow_mode)
  fine_y, off_y = stitch_elastic.compute_flow_map(
      tiles, cy[:, 0], axis=1, patch_size=(cfg.patch_size, cfg.patch_size),
      stride=stride_t, batch_size=cfg.flow_batch, flow_mode=cfg.flow_mode)

  coords_k = list(tiles.keys())
  fx_a, fy_a, x0, nbors, key_to_idx = stitch_elastic.aggregate_arrays(
      (cx[:, 0], fine_x, off_x), (cy[:, 0], fine_y, off_y), coords_k,
      coarse[:, 0], stride_t, tile_shape=tile_shape)
  nbors_j, fx_j, fy_j = (jnp.asarray(nbors), jnp.asarray(fx_a),
                         jnp.asarray(fy_a))

  def prev_fn(x):
    tgt = jax.vmap(functools.partial(
        stitch_elastic.compute_target_mesh, x=x, fx=fx_j, fy=fy_j,
        stride=stride_t))(nbors_j)
    return jnp.moveaxis(tgt, 0, 1)

  solved, _, steps = mesh.relax_mesh(jnp.asarray(x0), None, cfg.mesh_cfg,
                                     prev_fn=prev_fn)

  # Device slices: render_tiles_device stats-reduces them on device, so
  # the solved meshes never cross the link (callers np.asarray(solved)
  # if they need host values).
  maps = {k: solved[:, i:i + 1] for k, i in key_to_idx.items()}
  canvas, cmask, overflow = render_tiles_device(
      tiles, maps, stride=s, margin=cfg.margin, cfg=cfg)
  return dict(canvas=canvas, mask=cmask, solved=solved,
              key_to_idx=key_to_idx, cx=cx, cy=cy, coarse=coarse,
              overflow=overflow, solve_steps=steps)
