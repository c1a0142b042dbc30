"""Dense warping and montage rendering on device.

Capability parity with the reference renderer (/root/reference/warp.py):
  * `warp_subvolume` — warp [n, z, y, x] data by an inverse coordinate
    map. The reference densifies the map with scipy
    RegularGridInterpolator and resamples with OpenCV `cv.remap`
    (per-section host threads); here both stages are one jit device
    program per section batch: bilinear map densification
    (ops.interp.grid_sample_linear, with linear edge extrapolation) fused
    with a gather-based resampler supporting nearest / linear / cubic
    (Keys a=-0.75, OpenCV-compatible) / Lanczos4 kernels.
  * `ndimage_warp` — N-d warp with work-box tiling (RAM control) and an
    injectable `map_coordinates` for decorator composition.
  * `render_tiles` — montage rendering with margins, optional on-device
    CLAHE (ops.clahe), NaN-safe inverted-map generation.
  * `warp_points` — point-set warping.

Segmentation (uint64) data is relabeled to contiguous int32 on the host,
warped with nearest-neighbor sampling, and relabeled back — preserving
>2^32 ids exactly.
"""

from __future__ import annotations

import collections
import functools
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sofima_tpu import map_utils
from sofima_tpu.ops import clahe as clahe_ops
from sofima_tpu.ops import interp
from sofima_tpu.utils.bounding_box import BoundingBox
from sofima_tpu.utils.box_generator import BoxGenerator

_INTERP_METHODS = ('nearest', 'linear', 'cubic', 'lanczos')


def _normalize_interp(interpolation: str | None, dtype) -> str:
  if dtype == np.uint64:
    return 'nearest'
  if interpolation is None:
    return 'lanczos'
  if interpolation not in _INTERP_METHODS:
    raise ValueError(f'Unknown interpolation {interpolation!r}; '
                     f'expected one of {_INTERP_METHODS}')
  return interpolation


# -- Segmentation relabeling --------------------------------------------------


def make_contiguous(data: np.ndarray) -> tuple[np.ndarray, list]:
  """Maps arbitrary uint64 ids to dense [0, n) int space.

  Uses the multithreaded native relabel kernel when available.
  """
  orig_ids = np.unique(data)
  from sofima_tpu import native
  low = native.relabel(data, orig_ids)
  if low is None:
    low = np.searchsorted(orig_ids, data)
  return low, list(zip(orig_ids.tolist(), range(len(orig_ids))))


def _restore_labels(data: np.ndarray, orig_to_low: list,
                    old_uids: frozenset) -> np.ndarray:
  new_uids = frozenset(np.unique(data.astype(np.uint64)))
  diff = (new_uids - old_uids) - {0}
  assert not diff, f'Unexpected new ids after warp: {diff}'
  orig_ids = np.array([o for o, _ in orig_to_low], dtype=np.uint64)
  return orig_ids[data.astype(np.int64)]


# -- Core fused warp kernels --------------------------------------------------


@functools.partial(jax.jit, static_argnames=['method'])
def _warp_sections(images: jnp.ndarray, abs_map: jnp.ndarray,
                   map_grid_coords: jnp.ndarray, method: str) -> jnp.ndarray:
  """Densify + resample a batch of sections in one program.

  Args:
    images: [z, c, y, x] source data (float32)
    abs_map: [z, 2, my, mx] per-section absolute inverse maps (x, y chans)
      in source-image pixel coordinates
    map_grid_coords: [2, oy, ox] output-pixel coords in map-node units
      (y, x order)
    method: resampling kernel

  Returns:
    [z, c, oy, ox] warped data (float32; NaN where the map was invalid)
  """

  def one_section(img_c, m):
    dense_x = interp.grid_sample_linear(m[0], map_grid_coords)
    dense_y = interp.grid_sample_linear(m[1], map_grid_coords)
    coords = jnp.stack([dense_y, dense_x])
    return jax.vmap(
        lambda img: interp.sample(img, coords, method=method,
                                  mode='constant', cval=0.0))(img_c)

  return jax.vmap(one_section)(images, abs_map)


def warp_subvolume(
    image: np.ndarray,
    image_box: BoundingBox,
    coord_map: np.ndarray,
    map_box: BoundingBox,
    stride: float,
    out_box: BoundingBox,
    interpolation: str | None = None,
    offset: float = 0.0,
    parallelism: int = 1,
) -> np.ndarray:
  """Warps [n, z, y, x] data by an inverse coordinate map.

  Every map entry gives the source coordinate in `image` to read from.
  All sections and channels are processed in a single device dispatch;
  `parallelism` is accepted for API compatibility and ignored (the device
  program is already parallel).
  """
  del parallelism
  assert image.ndim == 4
  orig_dtype = image.dtype

  orig_to_low = None
  if image.dtype == np.uint64:
    method = 'nearest'
    image, orig_to_low = make_contiguous(image)
    assert image.max() < 2**31
    image = image.astype(np.int32)
    old_uids = frozenset(np.unique(image))
  else:
    method = _normalize_interp(interpolation, image.dtype)
    if image.dtype == np.uint32:
      if image.max() >= 2**16:
        raise ValueError('Image warping supports up to uint16; use uint64 '
                         'for segmentation data.')
      image = image.astype(np.uint16)

  skipped = np.all(np.isnan(coord_map), axis=(0, 2, 3))

  # Inverse map in absolute source-image-local pixel coordinates.
  abs_map = map_utils.to_absolute(np.asarray(coord_map, np.float32), stride)
  abs_map += (map_box.start[:2] * stride
              - image_box.start[:2] + offset).reshape(2, 1, 1, 1).astype(
                  np.float32)

  # Output pixel coordinates in map-node units (for map densification).
  out_y = (np.arange(int(out_box.size[1]), dtype=np.float32)
           + out_box.start[1] - offset) / stride - map_box.start[1]
  out_x = (np.arange(int(out_box.size[0]), dtype=np.float32)
           + out_box.start[0] - offset) / stride - map_box.start[0]
  grid = np.stack(np.meshgrid(out_y, out_x, indexing='ij'))

  images_j = jnp.asarray(
      np.moveaxis(image.astype(np.float32), 1, 0))  # [z, c, y, x]
  maps_j = jnp.asarray(np.moveaxis(abs_map, 1, 0))  # [z, 2, my, mx]

  warped = np.array(
      _warp_sections(images_j, maps_j, jnp.asarray(grid), method))
  warped = np.moveaxis(warped, 0, 1)  # [c, z, oy, ox]
  warped = np.nan_to_num(warped)
  warped[:, skipped] = 0.0

  if orig_to_low is not None:
    out = _restore_labels(np.rint(warped).astype(np.int64), orig_to_low,
                          old_uids)
  elif np.issubdtype(orig_dtype, np.integer):
    info = np.iinfo(orig_dtype)
    out = np.clip(np.rint(warped), info.min, info.max).astype(orig_dtype)
  else:
    out = warped.astype(orig_dtype)
  return out


def _default_map_coordinates(data, coords, order):
  return np.asarray(
      interp.map_coordinates(jnp.asarray(np.asarray(data, np.float32)),
                             jnp.asarray(np.array(coords, np.float32)),
                             order=order, mode='constant', cval=np.nan))


def _densify_box_3d(src_map_zyx, box_start, inv_stride, neg_off, box_shape):
  """Trilinear map densification for one work box, fully on device.

  `src_map_zyx`: [3, gz, gy, gx] absolute source coords at map nodes
  (channels z, y, x); `box_start` [3] global output-voxel origin of the
  box; returns [3, *box_shape] per-voxel source sampling coords.
  """
  coords = jnp.stack([
      (box_start[a] + jax.lax.broadcasted_iota(jnp.float32, box_shape, a)
       + neg_off[a]) * inv_stride[a] for a in range(3)
  ])
  return jnp.stack([
      interp.grid_sample_linear(src_map_zyx[a], coords) for a in range(3)
  ])


def ndimage_warp(
    image: np.ndarray,
    coord_map: np.ndarray,
    stride: Sequence[float],
    work_size: Sequence[int],
    overlap: Sequence[int],
    order: int = 1,
    map_coordinates=None,
    image_box: BoundingBox | None = None,
    map_box: BoundingBox | None = None,
    out_box: BoundingBox | None = None,
    parallelism: int = 1,
    out_scale: Sequence[float] = (1.0, 1.0, 1.0),
) -> np.ndarray:
  """N-d warp via dense coordinate lookup, tiled into work boxes.

  Args:
    image: [z,] y, x data to warp
    coord_map: [N, [z,] y, x] inverse coordinate map
    stride: [z,] y, x map node spacing in pixels
    work_size: xy[z] tile size (RAM control)
    overlap: xy[z] tile overlap
    order: 0, 1 or 3 (nearest/linear/cubic)
    map_coordinates: optional override with ndimage.map_coordinates
      signature (used by decorators to inject custom samplers)
    image_box/map_box/out_box: optional bounding boxes anchoring the data,
      the map, and the output in a global coordinate system
    parallelism: accepted for API compatibility (device is parallel)
    out_scale: xy[z] output-voxel / source-voxel scale for
      downsampling-aware rendering

  Returns:
    warped image covering out_box (or the image extent)
  """
  del parallelism
  if map_coordinates is None:
    map_coordinates = _default_map_coordinates

  shape = coord_map.shape[1:]
  dim = len(shape)
  assert dim == len(stride) == len(overlap) == len(work_size)
  if dim != image.ndim:
    raise ValueError(f'Dim mismatch: image {image.ndim} vs map {dim}')

  orig_to_low = None
  if image.dtype == np.uint64:
    image, orig_to_low = make_contiguous(image)
    old_uids = frozenset(np.unique(image))
    image = image.astype(np.int32)
    order = 0

  src_map = map_utils.to_absolute(np.asarray(coord_map, np.float32), stride)
  if map_box is not None:
    if image_box is None:
      raise ValueError('image_box required when map_box is given.')
    src_map += (map_box.start[:dim] * np.asarray(stride)[::-1]
                - image_box.start[:dim] / np.asarray(out_scale)[:dim]
                ).reshape((dim,) + (1,) * dim)
  reshaper = (slice(None),) + (np.newaxis,) * dim
  src_map = src_map * np.asarray(out_scale[:dim])[reshaper]

  sub_dim = 0
  image_size_xyz = image.shape[::-1]
  if dim == 2:
    work_size = list(work_size) + [1]
    overlap = list(overlap) + [0]
    image_size_xyz = list(image_size_xyz) + [1]
    sub_dim = 1

  if out_box is not None:
    warped = np.zeros(shape=tuple(int(s) for s in out_box.size[::-1]),
                      dtype=image.dtype)
  else:
    warped = np.zeros_like(image)
    out_box = BoundingBox(start=(0, 0, 0), size=image_size_xyz)

  gen = BoxGenerator(
      outer_box=BoundingBox(start=(0, 0, 0), size=out_box.size),
      box_size=work_size, box_overlap=overlap, back_shift_small_boxes=True)

  if map_box is not None:
    offset_zyx = (map_box.start * np.asarray(stride)[::-1]
                  - out_box.start)[::-1]
  else:
    offset_zyx = np.zeros(3)

  use_builtin = map_coordinates is _default_map_coordinates

  for i in range(gen.num_boxes):
    _, in_box = gen.generate(i)
    sel = [np.s_[int(s):int(e)] for s, e in zip(
        in_box.start[::-1][sub_dim:], in_box.end[::-1][sub_dim:])]
    box_coords = np.mgrid[tuple(sel)].astype(np.float32)
    map_coords = [(c - o) / s for c, s, o in zip(
        box_coords, stride, offset_zyx[sub_dim:] if dim == 3
        else offset_zyx[sub_dim:][:dim])]

    if use_builtin:
      # Densify with linear *extrapolation* past the last map node (same
      # contract as warp_subvolume's grid interpolator) so a map without
      # edge context doesn't poison the border.
      coords_j = jnp.asarray(np.stack(map_coords))
      dense = [np.asarray(interp.grid_sample_linear(
          jnp.asarray(chan), coords_j)) for chan in src_map[::-1]]
    else:
      dense = [map_coordinates(chan, map_coords, order=1)
               for chan in src_map[::-1]]

    sub_warped = map_coordinates(image, dense, order=order)
    sub_warped = np.nan_to_num(sub_warped)
    if np.issubdtype(image.dtype, np.integer):
      sub_warped = np.rint(sub_warped)

    out_sub = gen.index_to_cropped_box(i)
    rel = out_sub.translate(-in_box.start)
    warped[out_sub.to_slice3d()[sub_dim:]] = sub_warped[
        rel.to_slice3d()[sub_dim:]].astype(warped.dtype)

  if orig_to_low is not None:
    warped = _restore_labels(warped.astype(np.int64), orig_to_low, old_uids)
    return warped
  return warped.astype(image.dtype)


def render_tiles(
    tiles: dict[tuple[int, int], np.ndarray],
    coord_maps: dict[tuple[int, int], np.ndarray],
    stride: tuple[int, int] = (20, 20),
    margin: int = 50,
    parallelism: int = 1,
    width: int | None = None,
    height: int | None = None,
    use_clahe: bool = False,
    clahe_kwargs=None,
    margin_overrides: dict[tuple[int, int],
                           tuple[int, int, int, int]] | None = None,
    return_warped_tiles: bool = False,
    tile_masks: dict[tuple[int, int], np.ndarray] | None = None,
):
  """Warps a collection of tiles into one montage image.

  Args:
    tiles: (x, y) -> [ty, tx] tile image
    coord_maps: (x, y) -> [2, 1, my, mx] forward coordinate map per tile
    stride: map node spacing (only equal XY strides supported)
    margin: pixels at tile edges excluded from rendering
    parallelism: accepted for API compatibility
    width/height: output size (inferred if omitted)
    use_clahe: apply on-device CLAHE before warping
    clahe_kwargs: forwarded to ops.clahe.equalize_adapthist
    margin_overrides: (x, y) -> (top, bottom, left, right) margins
    return_warped_tiles: also return per-tile warped content + offsets
    tile_masks: (x, y) -> bool array; True marks pixels to render

  Returns:
    (canvas, mask) or (canvas, mask, {(x, y): (x0, y0, warped)}).
  """
  del parallelism
  if stride[0] != stride[1]:
    raise NotImplementedError('Only equal XY strides are supported.')

  any_tile = next(iter(tiles.values()))
  img_yx = any_tile.shape
  image_box = BoundingBox(start=(0, 0, 0), size=(img_yx[1], img_yx[0], 1))
  map_yx = next(iter(coord_maps.values())).shape[-2:]
  map_box = BoundingBox(start=(0, 0, 0), size=(map_yx[1], map_yx[0], 1))

  if width is None or height is None:
    max_x = max(x for x, _ in tiles)
    max_y = max(y for _, y in tiles)
    height, width = img_yx[0] * (max_y + 1), img_yx[1] * (max_x + 1)

  canvas = np.zeros((height, width), dtype=any_tile.dtype)
  canvas_mask = np.zeros((height, width), dtype=bool)
  warped_map: dict[tuple[int, int], Any] = {}
  clahe_kwargs = clahe_kwargs or {}

  for (tile_x, tile_y), coord_map in coord_maps.items():
    img = tiles.get((tile_x, tile_y))
    if img is None:
      continue

    tile_mask = None
    if tile_masks is not None:
      tile_mask = tile_masks.get((tile_x, tile_y))

    tg_box = map_utils.outer_box(coord_map, map_box, stride[0])
    tg_box = tg_box.adjusted_by(start=(-1, -1, 0), end=(1, 1, 0))
    inv = map_utils.invert_map(coord_map, map_box, tg_box, stride[0])
    inv = map_utils.fill_missing(inv, extrapolate=True)

    mask = np.zeros_like(img)
    if margin_overrides is not None and (tile_x, tile_y) in margin_overrides:
      top, bottom, left, right = margin_overrides[tile_x, tile_y]
      mask[top:-(bottom + 1), left:-(right + 1)] = 1
    else:
      mask[margin:-(margin + 1), margin:-(margin + 1)] = 1

    if use_clahe:
      img = (clahe_ops.equalize_adapthist(img, **clahe_kwargs)
             * np.iinfo(img.dtype).max).astype(img.dtype)

    if tile_mask is not None:
      mask[tile_mask == 0] = 0

    stacked = np.concatenate([
        img[np.newaxis, np.newaxis], mask[np.newaxis, np.newaxis]], axis=0)

    out_box = BoundingBox(
        start=((tg_box.start[0] + 1) * stride[1],
               (tg_box.start[1] + 1) * stride[0], 0),
        size=(int(tg_box.size[0] * stride[1]),
              int(tg_box.size[1] * stride[0]), 1))

    warped = warp_subvolume(stacked, image_box, inv, tg_box, stride[0],
                            out_box=out_box)
    warped_img = warped[0, 0]
    warped_mask = warped[1, 0].astype(bool)

    y0 = img_yx[0] * tile_y + int(out_box.start[1])
    x0 = img_yx[1] * tile_x + int(out_box.start[0])
    if x0 < 0:
      warped_img = warped_img[:, -x0:]
      warped_mask = warped_mask[:, -x0:]
      x0 = 0
    if y0 < 0:
      warped_img = warped_img[-y0:, :]
      warped_mask = warped_mask[-y0:, :]
      y0 = 0

    target = canvas[y0:y0 + warped_img.shape[0], x0:x0 + warped_img.shape[1]]
    th, tw = target.shape
    warped_img = warped_img[:th, :tw]
    warped_mask = warped_mask[:th, :tw]

    if return_warped_tiles:
      warped_map[(tile_x, tile_y)] = (x0, y0, warped_img)

    canvas_mask[y0:y0 + th, x0:x0 + tw][warped_mask] = True
    warped_mask = warped_mask & (warped_img > 0)
    target[warped_mask] = warped_img[warped_mask]

  if return_warped_tiles:
    return canvas, canvas_mask, warped_map
  return canvas, canvas_mask


def warp_points(points: np.ndarray, coord_map: np.ndarray,
                map_box: BoundingBox, stride: float) -> np.ndarray:
  """Warps [n, 3] XYZ points through a [2, z, y, x] coordinate map.

  Integer input dtypes are preserved (coordinates rounded).
  """
  points = np.asarray(points)
  assert points.ndim == 2 and points.shape[1] == 3
  assert coord_map.shape[0] == 2

  abs_map = map_utils.to_absolute(np.asarray(coord_map, np.float32), stride)
  abs_map += (map_box.start[:2] * stride).reshape(2, 1, 1, 1).astype(
      np.float32)

  by_z = collections.defaultdict(list)
  for i, p in enumerate(points):
    by_z[p[2]].append(i)

  ret = points.copy()
  for z, idxs in by_z.items():
    z_rel = int(z - map_box.start[2])
    # Query coords in map-node units (y, x).
    qy = (points[idxs, 1] / stride) - map_box.start[1]
    qx = (points[idxs, 0] / stride) - map_box.start[0]
    coords = jnp.asarray(np.stack([qy, qx]).astype(np.float32))
    dx = np.asarray(interp.grid_sample_linear(
        jnp.asarray(abs_map[0, z_rel]), coords))
    dy = np.asarray(interp.grid_sample_linear(
        jnp.asarray(abs_map[1, z_rel]), coords))
    if np.issubdtype(ret.dtype, np.integer):
      dx = np.round(dx).astype(ret.dtype)
      dy = np.round(dy).astype(ret.dtype)
    ret[idxs, 0] = dx
    ret[idxs, 1] = dy
  return ret
