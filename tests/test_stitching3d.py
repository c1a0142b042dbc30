"""3d volumetric tile stitching (LICONN-style): flow, solve, render."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sofima_tpu import mesh, stitch_elastic, stitch_rigid
from sofima_tpu.processor import warp as warp_proc
from sofima_tpu.utils.bounding_box import BoundingBox
from sofima_tpu.utils.subvolume import Subvolume


def _texture3d(shape_zyx, seed=0):
  rng = np.random.RandomState(seed)
  noise = rng.rand(*shape_zyx).astype(np.float32)
  f = np.fft.rfftn(noise)
  freqs = np.meshgrid(*[np.fft.fftfreq(s) for s in shape_zyx[:-1]]
                      + [np.fft.rfftfreq(shape_zyx[-1])], indexing='ij')
  r2 = sum(fr**2 for fr in freqs)
  f *= np.exp(-r2 / (2 * 0.12**2))
  tex = np.fft.irfftn(f, s=shape_zyx, axes=(0, 1, 2))
  tex = (tex - tex.min()) / np.ptp(tex)
  return (tex * 255).astype(np.float32)


class Tile:
  """[1, z, y, x] array-like with 4d slicing, as compute_flow_map3d expects."""

  def __init__(self, data_zyx):
    self.data = data_zyx[np.newaxis]
    self.shape = data_zyx.shape

  def __getitem__(self, sel):
    return self.data[sel]


class TestFlowMap3d:

  def test_two_tile_flow(self):
    # Volume 40x64x104 (zyx), two tiles of x-width 64 overlapping by 24.
    vol = _texture3d((40, 64, 104))
    t0 = vol[:, :, :64]
    t1 = vol[:, :, 40:]
    tile_map = {(0, 0): Tile(t0), (1, 0): Tile(t1)}
    offsets = np.zeros((3, 1, 1, 2))
    offsets[0, 0, 0, 0] = -24  # coarse x offset: 24 px overlap

    flows, used_offsets = stitch_elastic.compute_flow_map3d(
        tile_map, tile_shape=(64, 64, 40), offset_map=offsets, axis=0,
        patch_size=(20, 20, 20), stride=(8, 8, 8), batch_size=8)
    assert (0, 0) in flows
    f = flows[(0, 0)]
    assert f.shape[0] == 5
    valid = np.isfinite(f[0])
    assert valid.any()
    # Tiles cut from the same volume: flow ~ 0 everywhere valid.
    assert np.nanmedian(np.abs(f[0][valid])) <= 1.0
    assert np.nanmedian(np.abs(f[1][np.isfinite(f[1])])) <= 1.0
    off = used_offsets[(0, 0)]
    assert off[0] == -24

  def test_circular_mode_matches_padfield(self):
    # Device fast path: flow_mode='circular' routes overlap pairs
    # through the device-resident 3d strip kernel; integer peaks must
    # match the scattered-start padfield driver.
    vol = _texture3d((40, 64, 104))
    t0 = vol[:, :, :64]
    t1 = vol[:, :, 40:]
    tile_map = {(0, 0): Tile(t0), (1, 0): Tile(t1)}
    offsets = np.zeros((3, 1, 1, 2))
    offsets[0, 0, 0, 0] = -24
    kw = dict(tile_map=tile_map, tile_shape=(64, 64, 40),
              offset_map=offsets, axis=0, patch_size=(16, 16, 16),
              stride=(8, 8, 8), batch_size=8)
    ref_flows, ref_off = stitch_elastic.compute_flow_map3d(**kw)
    fast_flows, fast_off = stitch_elastic.compute_flow_map3d(
        flow_mode='circular', **kw)
    assert ref_off == fast_off
    for key in ref_flows:
      a, b = ref_flows[key], fast_flows[key]
      assert a.shape == b.shape
      for c in range(3):
        np.testing.assert_array_equal(np.nan_to_num(a[c], nan=9e9),
                                      np.nan_to_num(b[c], nan=9e9))

  def test_full_3d_stitch_and_render(self, tmp_path):
    vol = _texture3d((24, 48, 80), seed=3)
    overlap = 16
    t0 = vol[:, :, :48]
    t1 = vol[:, :, 32:]
    tile_map = {(0, 0): Tile(t0), (1, 0): Tile(t1)}
    stride = (8, 8, 8)

    cx = np.full((3, 1, 1, 2), np.nan)
    cx[:, 0, 0, 0] = (-overlap, 0, 0)
    cy = np.full((3, 1, 1, 2), np.nan)

    flows_x, off_x = stitch_elastic.compute_flow_map3d(
        tile_map, tile_shape=(48, 48, 24), offset_map=cx, axis=0,
        patch_size=(16, 16, 16), stride=stride, batch_size=8)

    coarse = np.zeros((3, 1, 1, 2), np.float32)
    coarse[0, 0, 0, 1] = -(48 - overlap - 48)  # = -(-overlap)? keep 0 base
    coarse[0, 0, 0, 1] = -overlap + 0  # tile 1 shifted left by overlap

    fx, fy, x0, nbors, key_to_idx = stitch_elastic.aggregate_arrays(
        (cx[:, 0], flows_x, off_x), (cy[:, 0], {}, {}),
        list(tile_map.keys()), coarse[:, 0], stride,
        tile_shape=(24, 48, 48))
    assert x0.shape == (3, 2, 3, 6, 6)
    assert nbors.shape == (2, 4, 11)

    fx_j, fy_j = jnp.asarray(fx), jnp.asarray(fy)
    nbors_j = jnp.asarray(nbors)

    def prev_fn(x):
      tgt = jax.vmap(functools.partial(
          stitch_elastic.compute_target_mesh, x=x, fx=fx_j, fy=fy_j,
          stride=stride))(nbors_j)
      return jnp.moveaxis(tgt, 0, 1)

    cfg = mesh.IntegrationConfig(
        dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(8, 8, 8),
        num_iters=200, max_iters=5000, stop_v_max=0.01, dt_max=100.0)
    solved, _, _ = mesh.relax_mesh(
        jnp.asarray(x0), None, cfg, prev_fn=prev_fn,
        mesh_force=mesh.elastic_mesh_3d)
    solved = np.asarray(solved)
    assert np.isfinite(solved).all()
    # Tile 1 stays ~overlap to the left of its nominal grid position.
    assert abs(solved[0, 1].mean() - solved[0, 0].mean() + overlap) < 3.0

    # ---- Render via StitchAndRender3dTiles. -----------------------------
    mesh_path = tmp_path / 'meshes.npz'
    np.savez(mesh_path, x=solved, key_to_idx=key_to_idx)

    class TestRender(warp_proc.StitchAndRender3dTiles):

      def _open_tile_volume(self, tile_id):
        return {0: t0, 1: t1}[tile_id]

    # Reset class caches (shared across instances).
    warp_proc.StitchAndRender3dTiles._tile_meshes = None
    warp_proc.StitchAndRender3dTiles._tile_boxes = {}
    warp_proc.StitchAndRender3dTiles._inverted_meshes = {}

    proc = TestRender(
        tile_map=[[0, 1]], tile_mesh_path=str(mesh_path), stride=(8, 8, 8),
        margin=2, work_size=(64, 64, 32))
    out_box = BoundingBox(start=(0, 8, 4), size=(72, 32, 12))
    sv = Subvolume(np.zeros((1,) + tuple(out_box.size[::-1]), np.float32),
                   out_box)
    result = proc.process(sv)
    rendered = result.data[0]

    # The montage reproduces the source volume where rendered (solver
    # gauge can shift the whole montage by a fraction of a node).
    mask = rendered > 0
    assert mask.mean() > 0.5
    truth = vol[4:16, 8:40, 0:72]
    err = np.abs(rendered - truth)[mask].mean()
    rel = err / truth.std()
    assert rel < 0.8, (err, truth.std())

    # ---- Device-resident chain (pipeline.stitch3d) must agree. ----------
    from sofima_tpu.pipeline import stitch3d
    cfg3 = stitch3d.Stitch3dConfig(
        stride=(8, 8, 8), patch_size=(16, 16, 16), flow_batch=8,
        margin=2, mesh_cfg=cfg)
    out = stitch3d.stitch_and_render_3d({(0, 0): t0, (1, 0): t1}, cx, cy,
                                        coarse, cfg3)
    canvas = np.asarray(out['canvas'])
    weights = np.asarray(out['weights'])
    assert canvas.shape == (24, 48, 96)
    # Same gauge/flows as the staged chain above: the canvas reproduces
    # the source volume over its covered interior.
    sel = np.s_[4:16, 8:40, 0:72]
    m2 = weights[sel] > 0
    assert m2.mean() > 0.5
    rel2 = np.abs(canvas[sel] - truth)[m2].mean() / truth.std()
    assert rel2 < 0.8, rel2
    # And agrees with the host processor's blended render where both
    # rendered (same EDT weights, same trilinear kernel; inversion
    # iteration counts differ slightly).
    both = m2 & mask
    assert both.mean() > 0.4
    diff = np.abs(canvas[sel] - rendered)[both].mean()
    assert diff < 2.0, diff
