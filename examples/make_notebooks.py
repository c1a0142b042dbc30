"""Generates the interactive notebooks under notebooks/.

The two notebooks mirror the reference's end-to-end recipes
(/root/reference/notebooks/em_alignment.ipynb and
liconn_inplane_stitching.ipynb) on self-contained synthetic data, driven
through sofima_tpu's public API. Cells are defined here as plain source
strings so the notebooks can be regenerated, diffed, and executed
headlessly by tests/test_notebooks.py (which runs every code cell in
order).

Run:  python examples/make_notebooks.py
"""

import json
import os

OUT_DIR = os.path.join(os.path.dirname(__file__), '..', 'notebooks')


def md(source):
  return {'cell_type': 'markdown', 'metadata': {},
          'source': source.splitlines(keepends=True)}


def code(source):
  return {'cell_type': 'code', 'metadata': {}, 'execution_count': None,
          'outputs': [], 'source': source.splitlines(keepends=True)}


def write_notebook(path, cells):
  nb = {
      'cells': cells,
      'metadata': {
          'kernelspec': {'display_name': 'Python 3', 'language': 'python',
                         'name': 'python3'},
          'language_info': {'name': 'python', 'version': '3'},
      },
      'nbformat': 4,
      'nbformat_minor': 5,
  }
  with open(path, 'w') as f:
    json.dump(nb, f, indent=1)
  print(f'wrote {path}')


# ---------------------------------------------------------------------------
# em_alignment.ipynb — serial-section alignment
# (mirrors /root/reference/notebooks/em_alignment.ipynb; see SURVEY.md §3.3)
# ---------------------------------------------------------------------------

EM_CELLS = [
    md("""# Alignment of EM sections

This notebook demonstrates fine alignment of a stack of serial EM
sections with **sofima_tpu** (a JAX rebuild of SOFIMA). It is
the twin of the reference `em_alignment.ipynb` recipe, running on
synthetic data so it is fully self-contained:

1. **Flow** — patch-wise masked cross-correlation between neighboring
   sections, at native and 2x-downsampled resolution.
2. **Clean + fuse** — filter unreliable flow vectors; fill holes in the
   high-resolution flow from the upsampled low-resolution flow.
3. **Solve** — relax an elastic spring mesh section by section, each
   section pulled toward the previous *solved* section through the flow.
4. **Invert + render** — invert the solved coordinate map and warp the
   raw sections into alignment.
5. **Blockwise solve** — the distributed variant: solve independent
   z-blocks in parallel and blend them with a low-z-resolution
   cross-block solution (`ReconcileCrossBlockMaps`).

On a GPU the flow and mesh kernels run as fused device programs; this
notebook also runs fine on CPU (set `FORCE_CPU = True`)."""),
    code("""import os
import numpy as np

FORCE_CPU = bool(int(os.environ.get('SOFIMA_NB_CPU', '0')))
if FORCE_CPU:
  import jax
  jax.config.update('jax_platforms', 'cpu')

import jax
import jax.numpy as jnp

from sofima_tpu import flow_field, flow_utils, map_utils, mesh, warp
from sofima_tpu.ops import interp
from sofima_tpu.utils.bounding_box import BoundingBox

print('backend:', jax.default_backend())"""),
    md("""## Synthetic data

A band-limited random texture stands in for EM contrast. Each section is
the previous one warped by a smooth incremental deformation — the
cumulative drift a real section series exhibits. `sections[z]` plays the
role of the unaligned input volume (the reference notebook streams this
from a TensorStore volume on GCS)."""),
    code("""n, stride, patch = 320, 20, 80
nz, block = 9, 4          # 9 sections, solved in 2 blocks of 4
grid_n = n // stride      # mesh nodes per side
pad = patch // 2 // stride  # flow-grid offset inside the node grid

rng = np.random.RandomState(0)
noise = rng.rand(n, n).astype(np.float32)
f = np.fft.rfft2(noise)
fy = np.fft.fftfreq(n)[:, None]
fx = np.fft.rfftfreq(n)[None, :]
f *= np.exp(-((fx**2 + fy**2) / (2 * 0.08**2)))
tex = np.fft.irfft2(f, s=(n, n))
tex = ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.float32)

y, x = np.mgrid[:n, :n].astype(np.float32)
amp = 2.0
dx = amp * np.sin(2 * np.pi * y / n)
dy = amp * np.cos(2 * np.pi * x / n)

sections = []
for z in range(nz):
  coords = np.stack([y + z * dy, x + z * dx])
  sections.append(np.asarray(interp.sample(
      jnp.asarray(tex), jnp.asarray(coords), method='linear',
      mode='nearest')))
sections = np.stack(sections)
sections.shape"""),
    code("""# 2x-downsampled copy (area averaging), like the reference's
# precomputed 2x volume.
sections_2x = sections.reshape(nz, n // 2, 2, n // 2, 2).mean((2, 4))
sections_2x.shape"""),
    md("""## Flow field estimation

`JAXMaskedXCorrWithStatsCalculator.flow_field` estimates, for every
patch on a `stride`-spaced grid, the XY shift that best matches the
current section to the *previous* one. The output has 4 channels:
`(flow_x, flow_y, peak sharpness, peak ratio)` — the last two are
quality statistics used for filtering.

The low-resolution pass sees *larger physical context* per patch (same
patch size on a 2x-downsampled image), so it recovers larger motions at
reduced precision — exactly the reference's multi-resolution scheme."""),
    code("""mfc = flow_field.JAXMaskedXCorrWithStatsCalculator()

def compute_flows(stack, patch_size, step):
  flows = []
  for z in range(1, stack.shape[0]):
    flows.append(mfc.flow_field(stack[z - 1], stack[z],
                                patch_size=patch_size, step=step,
                                batch_size=256))
  return np.array(flows)  # [z-1, 4, gy, gx]

flows_1x = compute_flows(sections, patch, stride)
flows_2x = compute_flows(sections_2x, patch, stride)
flows_1x.shape, flows_2x.shape"""),
    md("""The flow arrays are reordered to the coordinate-map layout
`[channels, z, y, x]` used everywhere else in the framework. Flow for
section `z` lives at index `z` (section 0 has no predecessor and keeps
an all-NaN flow)."""),
    code("""def to_czyx(flows):
  return np.moveaxis(flows, 0, 1)  # [4, z-1, gy, gx]

flows_1x = to_czyx(flows_1x)
flows_2x = to_czyx(flows_2x)
flows_1x.shape"""),
    md("""## Flow cleaning and multi-resolution fusion

`clean_flow` NaNs-out vectors with weak or ambiguous correlation peaks
and local outliers. The cleaned 2x flow is then resampled onto the 1x
node grid (`resample_map`; offsets are rescaled from 2x to 1x pixels)
and `reconcile_flows` merges the two in preference order — high-res
first, upsampled low-res filling its holes."""),
    code("""f1 = flow_utils.clean_flow(flows_1x, min_peak_ratio=1.4,
                           min_peak_sharpness=1.4, max_magnitude=40,
                           max_deviation=10)
f2 = flow_utils.clean_flow(flows_2x, min_peak_ratio=1.4,
                           min_peak_sharpness=1.4, max_magnitude=40,
                           max_deviation=10)

# Pad each flow onto its full node grid.
def pad_to_grid(fl, g, p):
  out = np.full((2, fl.shape[1], g, g), np.nan, np.float32)
  out[:, :, p:p + fl.shape[2], p:p + fl.shape[3]] = fl
  return out

grid_2x = (n // 2) // stride
full_1x = pad_to_grid(f1, grid_n, pad)
full_2x = pad_to_grid(f2, grid_2x, pad)

# Simulate a locally unreliable high-res flow (a crack/fold/debris
# region in real data): NaN out a square so the fusion has holes to
# fill from the low-res pass.
full_1x[:, :, 6:10, 6:10] = np.nan

# Upsample the 2x flow onto the 1x grid: node spacing halves, offsets
# (measured in 2x pixels) double.
box_2x = BoundingBox(start=(0, 0, 0), size=(grid_2x, grid_2x, 1))
box_1x = BoundingBox(start=(0, 0, 0), size=(grid_n, grid_n, 1))
f2_hires = map_utils.resample_map(
    full_2x * 2.0, box_2x, box_1x, src_stride=2 * stride,
    dst_stride=stride)

final_flow = flow_utils.reconcile_flows(
    (full_1x, f2_hires), max_gradient=0, max_deviation=20,
    min_patch_size=0)
print('valid fraction: 1x only', np.isfinite(full_1x[0]).mean().round(3),
      '-> fused', np.isfinite(final_flow[0]).mean().round(3))"""),
    code("""import matplotlib
matplotlib.use('Agg')  # headless-safe; harmless under Jupyter inline
import matplotlib.pyplot as plt

fig, ax = plt.subplots(1, 3, figsize=(9, 3))
ax[0].imshow(flows_1x[0, 3], vmin=-6, vmax=6); ax[0].set_title('raw x-flow (z=4)')
ax[1].imshow(full_1x[0, 3], vmin=-6, vmax=6); ax[1].set_title('cleaned')
ax[2].imshow(final_flow[0, 3], vmin=-6, vmax=6); ax[2].set_title('fused 1x+2x')
fig.tight_layout()"""),
    md("""## Mesh optimization

Each section's node grid is relaxed as an elastic spring mesh
(`relax_mesh_fused`, a single on-device FIRE loop). The mesh is pulled
toward `prev` — the previous *solved* section's node positions composed
with the current flow (`compose_maps_fast`) — while in-plane springs
keep the section rigid-ish. Solving sections in order propagates a
consistent geometry through the stack."""),
    code("""cfg = mesh.IntegrationConfig(
    dt=0.001, gamma=0.0, k0=0.1, k=0.1, stride=(stride, stride),
    num_iters=500, max_iters=20000, stop_v_max=0.01, dt_max=100.0,
    start_cap=0.01, final_cap=10.0, cap_scale=1.1)

def relax(prev, config=cfg):
  solved, e_kin, steps = mesh.relax_mesh_fused(
      jnp.zeros_like(jnp.asarray(prev)), jnp.asarray(prev), config)
  return np.asarray(solved)

def solve_step(flow_z, ref_mesh):
  prev = np.array(map_utils.compose_maps_fast(
      jnp.asarray(flow_z), (0.0, 0.0), (stride, stride),
      jnp.asarray(ref_mesh), (0.0, 0.0), (stride, stride)))
  return relax(prev)

flow_of = lambda z: final_flow[:, z - 1:z]

solved = [np.zeros((2, 1, grid_n, grid_n), np.float32)]
for z in range(1, nz):
  solved.append(solve_step(flow_of(z), solved[-1]))
solved_seq = np.concatenate(solved, axis=1)
solved_seq.shape"""),
    md("""## Image warping

Rendering needs the *inverse* map (for every output pixel: where to read
in the source). `invert_map` + `fill_missing(extrapolate=True)` produce
it; `warp_subvolume` then resamples every section with a Lanczos
kernel."""),
    code("""gbox = BoundingBox(start=(0, 0, 0), size=(grid_n, grid_n, 1))

def invert(m):
  out = map_utils.invert_map(m, gbox, gbox, stride)
  return map_utils.fill_missing(out, extrapolate=True)

def render(map_stack):
  img_box = BoundingBox(start=(0, 0, 0), size=(n, n, 1))
  out = []
  for z in range(nz):
    inv = invert(map_stack[:, z:z + 1])
    out.append(warp.warp_subvolume(
        sections[z][np.newaxis, np.newaxis], img_box, inv, gbox, stride,
        img_box, interpolation='lanczos')[0, 0])
  return np.stack(out)

aligned_seq = render(solved_seq)

def xz_view(stack):
  return stack[:, n // 2, :]  # an XZ cross-section through the middle

fig, ax = plt.subplots(1, 2, figsize=(10, 3))
ax[0].imshow(xz_view(sections), aspect=8, cmap='gray')
ax[0].set_title('XZ before alignment')
ax[1].imshow(xz_view(aligned_seq), aspect=8, cmap='gray')
ax[1].set_title('XZ after sequential solve')
fig.tight_layout()"""),
    code("""# Quantitative check: consecutive aligned sections should agree far
# better than the raw input (interior crop avoids warp boundary bands).
sel = np.s_[:, patch:-patch, patch:-patch]
before = np.abs(np.diff(sections, axis=0))[sel].mean()
after = np.abs(np.diff(aligned_seq, axis=0))[sel].mean()
print(f'mean |section difference|: before={before:.2f} after={after:.2f}')
assert after < 0.5 * before"""),
    md("""## Distributed mesh optimization (blockwise)

Sequential solving is a z-pipeline: section `z` needs section `z-1`.
For large stacks the reference splits z into **blocks** solved
independently (block-start sections pinned to zero = unoptimized), then
computes a **cross-block** solution over just the boundary sections,
and finally blends the two with `ReconcileCrossBlockMaps`: block starts
land exactly on the cross-block solution, interior sections interpolate
linearly.

First, the independent block solves (note both blocks start from
zeros — they know nothing about each other):"""),
    code("""zeros = np.zeros((2, 1, grid_n, grid_n), np.float32)
main = {0: zeros.copy(), block: zeros.copy()}
for z in range(1, block):
  main[z] = solve_step(flow_of(z), main[z - 1])
# z=4 as it WOULD be solved within block 0 (the 'last' mesh: it maps
# block 1's first section into block 0's geometry).
last4 = solve_step(flow_of(block), main[block - 1])
for z in range(block + 1, 2 * block):
  main[z] = solve_step(flow_of(z), main[z - 1])
last8 = solve_step(flow_of(2 * block), main[2 * block - 1])
main[2 * block] = last8

main_stack = np.concatenate([main[z] for z in range(nz)], axis=1)
# The naive blockwise solution has a geometry jump at the block seam:
seam_jump = np.nanmean(np.abs(last4 - main[block]))
print(f'block-seam discontinuity: {seam_jump:.2f} px')"""),
    md("""The cross-block solve aligns only the boundary sections
(z = 0, 4, 8), using the `last` meshes as flows between consecutive
block geometries. A weaker `k0` lets it act as a low-frequency
correction."""),
    code("""import dataclasses
xcfg = dataclasses.replace(cfg, k0=0.01)

xblock = [zeros.copy()]
for cross_flow in (last4, last8):
  prev = np.array(map_utils.compose_maps_fast(
      jnp.asarray(cross_flow), (0.0, 0.0), (stride, stride),
      jnp.asarray(xblock[-1]), (0.0, 0.0), (stride, stride)))
  xblock.append(relax(prev, xcfg))
xblock = np.concatenate(xblock, axis=1)
xblock.shape"""),
    md("""`ReconcileCrossBlockMaps` consumes the blockwise solution plus
inverses of the relevant maps (composition algebra
`offset = (xblock_pre^-1 . block_end^-1) . xblock_post`, applied with a
linear z-ramp inside each block)."""),
    code("""from sofima_tpu.processor import maps as maps_proc
from sofima_tpu.utils.subvolume import Subvolume
from sofima_tpu.utils.volume import InMemoryVolume

main_inv = np.zeros_like(main_stack)
main_inv[:, 8:9] = invert(main[8])
last_inv = np.zeros_like(main_stack)
last_inv[:, 4:5] = invert(last4)
xblock_inv = np.concatenate(
    [invert(xblock[:, i:i + 1]) for i in range(3)], axis=1)

reconcile = maps_proc.ReconcileCrossBlockMaps(
    maps_proc.ReconcileCrossBlockMaps.Config(
        cross_block=InMemoryVolume(xblock),
        cross_block_inv=InMemoryVolume(xblock_inv),
        last_inv=InMemoryVolume(last_inv),
        main_inv=InMemoryVolume(main_inv),
        z_map={'0': 0, '4': 1, '8': 2},
        stride=stride,
        xy_overlap=2))
box = BoundingBox(start=(0, 0, 0), size=(grid_n, grid_n, nz))
blended = reconcile.process(Subvolume(main_stack.copy(), box))
z0 = int(blended.bbox.start[2])
c0 = int(blended.bbox.start[0])
global_map = np.full_like(main_stack, np.nan)
global_map[:, z0:z0 + blended.data.shape[1],
           c0:c0 + blended.data.shape[2],
           c0:c0 + blended.data.shape[3]] = blended.data
global_map = np.where(np.isnan(global_map), main_stack, global_map)
global_map.shape"""),
    code("""aligned_naive = render(main_stack)
aligned_blk = render(global_map)

fig, ax = plt.subplots(1, 2, figsize=(10, 3))
ax[0].imshow(xz_view(aligned_naive), aspect=8, cmap='gray')
ax[0].set_title('naive blockwise (seam at z=4)')
ax[1].imshow(xz_view(aligned_blk), aspect=8, cmap='gray')
ax[1].set_title('blended via ReconcileCrossBlockMaps')
fig.tight_layout()

# The metric that matters for the blend is the BLOCK SEAM: sections
# z=3 (end of block 0) and z=4 (start of block 1) live in unrelated
# geometries in the naive solution; the blend must remove that jump.
# (Interior sections carry the intentional interpolation ramp, so the
# whole-stack consecutive-diff of the blend sits between the naive
# blockwise and the sequential solve.)
crop = np.s_[patch:-patch, patch:-patch]
seam = lambda a: np.abs(a[block] - a[block - 1])[crop].mean()
print(f'seam |z=4 - z=3|: unaligned={seam(sections):.2f} '
      f'naive-blockwise={seam(aligned_naive):.2f} '
      f'blended={seam(aligned_blk):.2f} '
      f'(sequential={seam(aligned_seq):.2f})')
assert seam(aligned_blk) < 0.7 * seam(aligned_naive)
assert seam(aligned_blk) < 0.7 * seam(sections)
print('PASS')"""),
]

# ---------------------------------------------------------------------------
# liconn_inplane_stitching.ipynb — volumetric tile montage
# (mirrors /root/reference/notebooks/liconn_inplane_stitching.ipynb;
#  SURVEY.md §3.4)
# ---------------------------------------------------------------------------

LICONN_CELLS = [
    md("""# In-plane stitching of volumetric (LICONN-style) tiles

This notebook stitches a 2x2 grid of overlapping **3d tiles** into one
volume with **sofima_tpu** — the twin of the reference
`liconn_inplane_stitching.ipynb`, self-contained on synthetic data:

1. **Coarse tile positioning** — whole-overlap cross-correlation between
   neighboring tiles (`stitch_rigid.compute_coarse_offsets`) and a
   tile-level spring solve (`optimize_coarse_mesh`).
2. **Fine alignment** — dense 3d flow over every tile-pair overlap
   (`stitch_elastic.compute_flow_map3d`), filtered with `clean_flow`.
3. **Joint elastic solve** — all tile meshes relax simultaneously,
   coupled through composed neighbor flows
   (`compute_target_mesh` as `prev_fn` for `relax_mesh`).
4. **Rendering** — distance-transform-blended montage via the
   `StitchAndRender3dTiles` processor."""),
    code("""import os
import numpy as np

FORCE_CPU = bool(int(os.environ.get('SOFIMA_NB_CPU', '0')))
if FORCE_CPU:
  import jax
  jax.config.update('jax_platforms', 'cpu')

import functools
import jax
import jax.numpy as jnp

from sofima_tpu import flow_utils, mesh, stitch_elastic, stitch_rigid
print('backend:', jax.default_backend())"""),
    md("""## Data loading and tile layout

A synthetic 3d volume is cut into a 2x2 grid of tiles with 16 px
overlap in x and y. `tile_layout` defines the spatial arrangement
(entries are tile ids; the reference reads this layout plus per-tile
TensorStore volumes from GCS). Each tile behaves like a
`[channels, z, y, x]` array — the duck type the stitching API
consumes."""),
    code("""def make_volume(shape_zyx, seed=3):
  rng = np.random.RandomState(seed)
  noise = rng.rand(*shape_zyx).astype(np.float32)
  f = np.fft.rfftn(noise, axes=(0, 1, 2))
  freqs = np.meshgrid(*[np.fft.fftfreq(s) for s in shape_zyx[:-1]]
                      + [np.fft.rfftfreq(shape_zyx[-1])], indexing='ij')
  f *= np.exp(-sum(fr**2 for fr in freqs) / (2 * 0.12**2))
  vol = np.fft.irfftn(f, s=shape_zyx, axes=(0, 1, 2))
  vol = (vol - vol.min()) / np.ptp(vol)
  return (vol * 255).astype(np.float32)

tile_size, overlap, nzt = 48, 16, 24
step = tile_size - overlap
extent = step + tile_size  # 80
vol = make_volume((nzt, extent, extent))

tile_layout = np.array([[0, 1],
                        [2, 3]])

class Tile:
  \"\"\"[c, z, y, x] view of a tile cut from the source volume.\"\"\"

  def __init__(self, data_zyx):
    self.data = np.ascontiguousarray(data_zyx)[np.newaxis]
    self.shape = self.data.shape

  def __getitem__(self, sel):
    return self.data[sel]

tile_data = {}
tile_map = {}
for ty in range(2):
  for tx in range(2):
    cut = vol[:, ty * step:ty * step + tile_size,
              tx * step:tx * step + tile_size]
    tile_data[(tx, ty)] = cut
    tile_map[(tx, ty)] = Tile(cut)
print({k: v.shape for k, v in tile_map.items()})"""),
    md("""## Coarse tile positioning

`compute_coarse_offsets` estimates one whole-overlap translation per
neighboring tile pair (a single full-patch masked cross-correlation at
several candidate overlap widths, preferring mutually consistent
estimates). It runs on 2d images; the central z-slice of each tile is a
robust proxy for in-plane tile placement. The result arrays use
`inf` for failed estimates and `NaN` for missing tiles."""),
    code("""mid = {k: v[nzt // 2] for k, v in tile_data.items()}
ov = (overlap - 4, overlap + 8)
cx, cy = stitch_rigid.compute_coarse_offsets(
    (2, 2), mid, overlaps_xy=(ov, ov), min_overlap=8)
print('cx (x-neighbors):', cx[:, 0], sep='\\n')
print('cy (y-neighbors):', cy[:, 0], sep='\\n')"""),
    code("""# Lift to 3 channels (dx, dy, dz=0) and solve the tile-level mesh
# with the 3d force so the coarse mesh carries a z coordinate too.
def lift(c):
  out = np.full((3,) + c.shape[1:], np.nan, np.float32)
  out[:2] = c
  out[2] = np.where(np.isfinite(c[0]), 0.0, np.nan)
  return out

cx3, cy3 = lift(cx), lift(cy)
coarse_mesh = stitch_rigid.optimize_coarse_mesh(
    cx3, cy3, mesh_fn=stitch_rigid.elastic_tile_mesh_3d)
coarse_mesh.round(1)"""),
    md("""### Verify tile positions on a single XY slice

Paste the central slice of every tile at its coarse position — the tile
content should line up in the overlaps (up to the fine deformation the
elastic stage removes next)."""),
    code("""import matplotlib
matplotlib.use('Agg')
import matplotlib.pyplot as plt

canvas = np.zeros((extent + 8, extent + 8), np.float32)
for (tx, ty), img in mid.items():
  oy = int(round(ty * step + coarse_mesh[1, 0, ty, tx]))
  ox = int(round(tx * step + coarse_mesh[0, 0, ty, tx]))
  canvas[oy + 4:oy + 4 + tile_size, ox + 4:ox + 4 + tile_size] = img
plt.figure(figsize=(4, 4))
plt.imshow(canvas, cmap='gray')
plt.title('coarse placement, central XY slice')"""),
    md("""## Fine tile alignment

`compute_flow_map3d` crops the stride-aligned overlap region of each
neighboring tile pair and estimates a dense 3d flow field (5 channels:
xyz offsets + 2 quality stats) over it. `clean_flow` filters weak
estimates exactly as in serial-section alignment."""),
    code("""stride3 = (8, 8, 8)
tile_shape_xyz = (tile_size, tile_size, nzt)

flow_x, offsets_x = stitch_elastic.compute_flow_map3d(
    tile_map, tile_shape=tile_shape_xyz, offset_map=cx3, axis=0,
    patch_size=(16, 16, 16), stride=stride3, batch_size=16)
flow_y, offsets_y = stitch_elastic.compute_flow_map3d(
    tile_map, tile_shape=tile_shape_xyz, offset_map=cy3, axis=1,
    patch_size=(16, 16, 16), stride=stride3, batch_size=16)

fine_x = {k: flow_utils.clean_flow(v, min_peak_ratio=1.2,
                                   min_peak_sharpness=1.2,
                                   max_magnitude=0, max_deviation=5,
                                   dim=3)
          for k, v in flow_x.items()}
fine_y = {k: flow_utils.clean_flow(v, min_peak_ratio=1.2,
                                   min_peak_sharpness=1.2,
                                   max_magnitude=0, max_deviation=5,
                                   dim=3)
          for k, v in flow_y.items()}
{k: v.shape for k, v in fine_x.items()}"""),
    md("""## Joint mesh optimization

`aggregate_arrays` packs per-tile meshes (seeded from the coarse
solution) and all pairwise flows into dense arrays plus a neighbor
table. During relaxation, `compute_target_mesh` turns each tile's
neighbors' *current* positions + flows into virtual-spring targets
(`prev_fn`), so all tile meshes relax simultaneously and stay mutually
consistent."""),
    code("""coords = list(tile_map.keys())
fx, fy, x0, nbors, key_to_idx = stitch_elastic.aggregate_arrays(
    (cx3[:, 0], fine_x, offsets_x), (cy3[:, 0], fine_y, offsets_y),
    coords, coarse_mesh[:, 0], stride3,
    tile_shape=(nzt, tile_size, tile_size))

fx_j, fy_j, nbors_j = jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(nbors)

def prev_fn(x):
  tgt = jax.vmap(functools.partial(
      stitch_elastic.compute_target_mesh, x=x, fx=fx_j, fy=fy_j,
      stride=stride3))(nbors_j)
  return jnp.moveaxis(tgt, 0, 1)

config = mesh.IntegrationConfig(
    dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=stride3, num_iters=200,
    max_iters=10000, stop_v_max=0.01, dt_max=100.0)
solved, e_kin, steps = mesh.relax_mesh(
    jnp.asarray(x0), None, config, prev_fn=prev_fn,
    mesh_force=mesh.elastic_mesh_3d)
solved = np.asarray(solved)
# Fix the solver's global-translation gauge (spring forces are purely
# relative): anchor tile (0, 0) at its nominal position so the montage
# lands in the source volume's coordinate frame.
anchor = np.nanmean(solved[:, key_to_idx[(0, 0)]], axis=(1, 2, 3))
solved = solved - anchor[:, None, None, None, None]
print('solved in', int(steps), 'steps; mesh array', solved.shape)"""),
    code("""# Persist the solved meshes — the npz {x, key_to_idx} contract the
# rendering processor consumes.
import tempfile
from sofima_tpu.utils import checkpoint

workdir = tempfile.mkdtemp()
mesh_path = os.path.join(workdir, 'solved_mesh_st8.npz')
checkpoint.save_mesh_npz(mesh_path, solved, key_to_idx)
mesh_path"""),
    md("""## Rendering the stitched volume

`StitchAndRender3dTiles` renders any requested output box: it inverts
each tile's mesh once (cached), warps the tile data, and blends
overlapping tiles with Euclidean-distance-transform weights. Deployments
subclass it to plug in their tile storage — here the tiles come from
memory."""),
    code("""from sofima_tpu.processor import warp as warp_proc
from sofima_tpu.utils.bounding_box import BoundingBox
from sofima_tpu.utils.subvolume import Subvolume

class Render(warp_proc.StitchAndRender3dTiles):

  def _open_tile_volume(self, tile_id):
    return tile_data[coords[tile_id]]

# Class-level caches are keyed per run.
warp_proc.StitchAndRender3dTiles._tile_meshes = None
warp_proc.StitchAndRender3dTiles._tile_boxes = {}
warp_proc.StitchAndRender3dTiles._inverted_meshes = {}

id_grid = [[key_to_idx[(tx, ty)] for tx in range(2)] for ty in range(2)]
renderer = Render(tile_map=id_grid, tile_mesh_path=mesh_path,
                  stride=stride3, margin=2, work_size=(96, 96, 32))

out_box = BoundingBox(start=(4, 4, 4), size=(extent - 8, extent - 8, 12))
sv = Subvolume(np.zeros((1,) + tuple(out_box.size[::-1]), np.float32),
               out_box)
stitched = renderer.process(sv).data[0]
stitched.shape"""),
    code("""fig, ax = plt.subplots(1, 2, figsize=(8, 4))
ax[0].imshow(vol[10, 4:extent - 4, 4:extent - 4], cmap='gray')
ax[0].set_title('source volume (z=10)')
ax[1].imshow(stitched[6], cmap='gray')
ax[1].set_title('stitched montage (z=10)')
fig.tight_layout()

mask = stitched > 0
truth = vol[4:16, 4:extent - 4, 4:extent - 4]
rel_err = np.abs(stitched - truth)[mask].mean() / truth.std()
print(f'montage vs source: rel err={rel_err:.3f} '
      f'(coverage {mask.mean():.1%})')
assert rel_err < 0.8 and mask.mean() > 0.5
print('PASS')"""),
]


def main():
  os.makedirs(OUT_DIR, exist_ok=True)
  write_notebook(os.path.join(OUT_DIR, 'em_alignment.ipynb'), EM_CELLS)
  write_notebook(os.path.join(OUT_DIR, 'liconn_inplane_stitching.ipynb'),
                 LICONN_CELLS)


if __name__ == '__main__':
  main()
