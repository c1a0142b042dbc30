"""End-to-end serial-section alignment on synthetic data.

Mirrors the reference's em_alignment workflow (SURVEY.md §3.3) on a
generated 2-section stack:

  1. FLOW    flow_field on a deformed copy of a texture section
  2. CLEAN   clean_flow quality filtering
  3. SOLVE   relax_mesh with the flow as 'prev' spring targets
  4. INVERT  invert_map of the solved mesh
  5. RENDER  warp_subvolume of the moving section

Success criterion: the rendered section matches the reference section far
better than the unaligned input (residual reduced by >5x).

Run:  python examples/e2e_alignment.py [--size 1024] [--stride 40]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def make_texture(n: int, seed: int = 0) -> np.ndarray:
  """Band-limited random texture with EM-like contrast."""
  rng = np.random.RandomState(seed)
  noise = rng.rand(n, n).astype(np.float32)
  f = np.fft.rfft2(noise)
  fy = np.fft.fftfreq(n)[:, None]
  fx = np.fft.rfftfreq(n)[None, :]
  f *= np.exp(-((fx**2 + fy**2) / (2 * 0.08**2)))
  tex = np.fft.irfft2(f, s=(n, n))
  tex = (tex - tex.min()) / np.ptp(tex)
  return (tex * 255).astype(np.uint8)


def smooth_deformation(n: int, amplitude: float) -> np.ndarray:
  """[2, y, x] forward deformation field (xy channels, in pixels)."""
  y, x = np.mgrid[:n, :n].astype(np.float32)
  dx = amplitude * np.sin(2 * np.pi * y / n) * np.cos(2 * np.pi * x / n / 2)
  dy = amplitude * np.cos(2 * np.pi * x / n) * np.sin(2 * np.pi * y / n / 2)
  return np.stack([dx, dy])


def align_pair(n: int = 1024, stride: int = 40, patch: int = 160,
               amplitude: float = 12.0, log=print) -> dict:
  """Runs the five-stage chain on a synthetic pair; returns its quality.

  The result holds the mean residual flow magnitude before and after
  alignment (px), the interior pixel residuals, and `ok`: the PASS rule
  (residual flow < 1.5 px and reduced > 5x).
  """
  import jax.numpy as jnp
  from sofima_tpu import flow_field, flow_utils, map_utils, mesh, warp
  from sofima_tpu.utils import BoundingBox

  log(f'[e2e] generating {n}x{n} synthetic section pair...')
  pre = make_texture(n)
  deform = smooth_deformation(n, amplitude)

  # Build the 'post' section by warping 'pre' with the inverse deformation.
  grid = np.mgrid[:n, :n].astype(np.float32)
  sample_y = grid[0] + deform[1]
  sample_x = grid[1] + deform[0]
  from sofima_tpu.ops import interp
  post = np.asarray(interp.sample(
      jnp.asarray(pre.astype(np.float32)),
      jnp.asarray(np.stack([sample_y, sample_x])), method='linear',
      mode='nearest')).astype(np.uint8)

  # 1. FLOW
  t0 = time.time()
  mfc = flow_field.JAXMaskedXCorrWithStatsCalculator()
  flow = mfc.flow_field(pre, post, patch_size=patch, step=stride,
                        batch_size=256)
  log(f'[e2e] flow: grid {flow.shape}, {time.time() - t0:.1f}s')

  # 2. CLEAN
  flow = flow[:, np.newaxis]  # [4, z=1, y, x]
  clean = flow_utils.clean_flow(flow, min_peak_ratio=1.6,
                                min_peak_sharpness=1.6, max_magnitude=40,
                                max_deviation=10)
  valid_frac = np.isfinite(clean[0]).mean()
  log(f'[e2e] clean: {valid_frac:.2%} vectors valid')

  # Pad the flow grid to the full section node grid (flow is computed on
  # the patch-interior grid; offset by patch/2/stride nodes).
  pad = patch // 2 // stride
  grid_n = n // stride
  full_flow = np.full((2, 1, grid_n, grid_n), np.nan, np.float32)
  full_flow[:, :, pad:pad + clean.shape[2], pad:pad + clean.shape[3]] = clean

  # 3. SOLVE
  t0 = time.time()
  cfg = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.1, k=0.1, stride=(stride, stride),
      num_iters=1000, max_iters=100000, stop_v_max=0.005, dt_max=100.0,
      start_cap=0.01, final_cap=10.0, cap_scale=1.1,
      prefer_orig_order=True)
  solved, _, steps = mesh.relax_mesh_fused(
      jnp.zeros_like(jnp.asarray(full_flow)), jnp.asarray(full_flow), cfg)
  solved = np.asarray(solved)
  log(f'[e2e] solve: {int(steps)} steps, {time.time() - t0:.1f}s')

  # 4. INVERT
  t0 = time.time()
  box = BoundingBox(start=(0, 0, 0), size=(grid_n, grid_n, 1))
  inv = map_utils.invert_map(solved, box, box, stride)
  inv = map_utils.fill_missing(inv, extrapolate=True)
  log(f'[e2e] invert: {time.time() - t0:.1f}s')

  # 5. RENDER
  t0 = time.time()
  img_box = BoundingBox(start=(0, 0, 0), size=(n, n, 1))
  rendered = warp.warp_subvolume(
      post[np.newaxis, np.newaxis], img_box, inv, box, stride, img_box,
      interpolation='lanczos')
  log(f'[e2e] render: {time.time() - t0:.1f}s')

  # Quality: estimate the residual flow between the rendered section and
  # the reference; alignment succeeded if it collapsed to ~0 px.
  resid_flow = mfc.flow_field(pre, rendered[0, 0], patch_size=patch,
                              step=stride, batch_size=256)
  resid_mag = np.hypot(resid_flow[0], resid_flow[1])
  orig_mag = np.hypot(flow[0, 0], flow[1, 0])
  before = float(np.nanmean(orig_mag))
  after = float(np.nanmean(resid_mag))
  log(f'[e2e] mean |flow|: before={before:.2f} px, after '
      f'alignment={after:.2f} px')

  interior = np.s_[patch:-patch, patch:-patch]
  px_before = float(np.abs(post.astype(np.float32) - pre)[interior].mean())
  px_after = float(
      np.abs(rendered[0, 0].astype(np.float32) - pre)[interior].mean())
  log(f'[e2e] mean |pixel residual| interior: before={px_before:.2f} '
      f'after={px_after:.2f}')

  # Note: flow vectors are integer-quantized, so ~1 px mean is the
  # measurement floor for a sub-pixel-accurate alignment.
  ok = after < 1.5 and after < before / 5
  return dict(before=before, after=after, px_before=px_before,
              px_after=px_after, ok=ok)


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument('--size', type=int, default=1024)
  parser.add_argument('--stride', type=int, default=40)
  parser.add_argument('--patch', type=int, default=160)
  parser.add_argument('--amplitude', type=float, default=12.0)
  parser.add_argument('--cpu', action='store_true',
                      help='force the CPU backend')
  args = parser.parse_args()

  if args.cpu:
    import jax
    jax.config.update('jax_platforms', 'cpu')

  result = align_pair(args.size, args.stride, args.patch, args.amplitude)
  print('[e2e]', 'PASS' if result['ok'] else 'FAIL')
  return 0 if result['ok'] else 1


if __name__ == '__main__':
  sys.exit(main())
