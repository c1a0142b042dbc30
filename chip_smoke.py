"""Smoke test of the alignment system on one NVIDIA GPU.

Drives the main paths once, at the sizes users run, through the
library's own entry points, and checks every result against a plain
reference. All data is synthetic and made from fixed seeds on the device.

  stack     16 sections of 10000^2 uint8 (EM-like texture under a known
            drift + wobble deformation) through
            pipeline.stack_align.align_stack, then align_step on the
            first 3 sections; gated on the worst-section error against
            the anchor section and on the envelope flag.
  ops       each device op of that path at full width vs its plain
            reference: the targeted fine flow pass vs the untargeted
            dense grid, the Lanczos gather render vs the same sampler on
            the CPU, relax_mesh_fused vs the staged relax_mesh, and the
            float32 flow vs the same flow computed on the CPU.
  montage   pipeline.montage on a 3x3 grid of 3600^2 tiles.
  stitch3d  pipeline.stitch3d on a 2x2 grid of 64 x 576^2 tiles.
  api       the README quick-start chain on a 4096^2 pair.

Run:  python chip_smoke.py              one GPU, all phases above
      python chip_smoke.py --multichip  four GPUs: relax_mesh_sharded on
                                        1x4 and 2x2 device meshes and
                                        dense_flow_field_sharded, each vs
                                        the single-device result

Exits non-zero without a result when JAX finds no GPU or any phase
fails. Per-phase metrics go to stdout as `[phase] {json}` lines; the
last stdout line is one JSON object naming the device.
"""

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

from examples.e2e_alignment import align_pair
from sofima_tpu import flow_field
from sofima_tpu import mesh
from sofima_tpu.ops import interp
from sofima_tpu.parallel import mesh_sharding
from sofima_tpu.pipeline import montage
from sofima_tpu.pipeline import stack_align
from sofima_tpu.pipeline import stitch3d

REPO = os.path.dirname(os.path.abspath(__file__))


class GateError(AssertionError):
  """A quality gate of a phase did not hold."""


def _gate(ok, message: str):
  if not ok:
    raise GateError(message)


def enable_compile_cache():
  """Persistent compile cache: $JAX_COMPILATION_CACHE_DIR, else .jax_cache.

  JAX reads the environment variable itself; only its absence needs a
  directory, which is kept inside the checkout (listed in .gitignore).
  """
  if not os.environ.get('JAX_COMPILATION_CACHE_DIR'):
    jax.config.update('jax_compilation_cache_dir',
                      os.path.join(REPO, '.jax_cache'))
  jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.5)


def _peak_bytes():
  stats = jax.local_devices()[0].memory_stats() or {}
  return stats.get('peak_bytes_in_use')


def _timed(fn):
  """(result, seconds) of fn() with every output leaf ready."""
  t0 = time.perf_counter()
  out = jax.block_until_ready(fn())
  return out, time.perf_counter() - t0


@functools.partial(jax.jit, static_argnames=('shape', 'sigma'))
def texture(key, shape, sigma=0.08):
  """Band-limited uniform noise scaled to [0, 255] (EM-like contrast)."""
  noise = jax.random.uniform(key, shape, jnp.float32)
  freqs = [jnp.fft.fftfreq(n) for n in shape[:-1]]
  freqs.append(jnp.fft.rfftfreq(shape[-1]))
  r2 = 0.0
  for axis, q in enumerate(freqs):
    r2 = r2 + (q**2).reshape([-1 if a == axis else 1
                              for a in range(len(shape))])
  img = jnp.fft.irfftn(jnp.fft.rfftn(noise) * jnp.exp(-r2 / (2 * sigma**2)),
                       s=shape)
  lo, hi = jnp.min(img), jnp.max(img)
  return (img - lo) / (hi - lo) * 255.0


@functools.partial(jax.jit, static_argnames=('stride',))
def deform(base, disp_yx, stride):
  """base sampled at q + disp(q) (linear), disp given on stride nodes."""
  n_y, n_x = base.shape
  dense = interp.upsample_map_linear(disp_yx, stride, (0, 0), (n_y, n_x))
  yy = jnp.arange(n_y, dtype=jnp.float32)[:, None]
  xx = jnp.arange(n_x, dtype=jnp.float32)[None, :]
  out = interp.sample(base, jnp.stack([yy + dense[0], xx + dense[1]]),
                      method='linear', mode='constant', cval=0.0)
  return jnp.clip(out + 0.5, 0, 255).astype(jnp.uint8)


def _stack_disp(z, grid_n, stride):
  """Known deformation of section z: cumulative drift + smooth wobble."""
  gm_y, gm_x = np.mgrid[:grid_n, :grid_n].astype(np.float32) * stride
  dy = 2.5 * z + 7.0 * np.sin(2 * np.pi * gm_x / 2500.0 + 0.7 * z)
  dx = -2.0 * z + 7.0 * np.cos(2 * np.pi * gm_y / 2500.0 + 0.4 * z)
  return np.stack([dy, dx]).astype(np.float32)


def make_stack(n, n_z, stride=40, seed=0):
  """[n_z, n, n] uint8 stack: section z = anchor under _stack_disp(z)."""
  base = texture(jax.random.PRNGKey(seed), (n, n))
  base_u8 = jnp.clip(base + 0.5, 0, 255).astype(jnp.uint8)
  sections = [base_u8]
  for z in range(1, n_z):
    sections.append(deform(base_u8.astype(jnp.float32),
                           jnp.asarray(_stack_disp(z, n // stride, stride)),
                           stride))
  return jnp.stack(sections)


def phase_stack(n=10000, n_z=16, seed=0):
  """16 x 10k^2 stack through align_stack and align_step (ground truth)."""
  stack = jax.block_until_ready(make_stack(n, n_z, seed=seed))
  cfg = stack_align.StackAlignConfig(max_displacement=128, residual=6,
                                     peak_crop=32, warm_start=False)
  cfg = dataclasses.replace(
      cfg, mesh=dataclasses.replace(cfg.mesh, num_iters=125))
  margin = min(320, n // 4)
  inter = np.s_[margin:-margin, margin:-margin]

  @jax.jit
  def section_errors(rendered, anchor):
    anchor = anchor[inter].astype(jnp.float32)
    return jax.lax.map(
        lambda r: jnp.mean(jnp.abs(r[inter].astype(jnp.float32) - anchor)),
        rendered[1:])

  def run():
    rendered, _, overflow = stack_align.align_stack(stack, cfg,
                                                    out_dtype=jnp.uint8)
    return section_errors(rendered, stack[0]), overflow

  (errs, overflow), first_s = _timed(run)
  (errs, overflow), warm_s = _timed(run)
  errs = np.asarray(errs)
  raw_err = float(jnp.mean(jnp.abs(stack[-1][inter].astype(jnp.float32)
                                   - stack[0][inter].astype(jnp.float32))))

  # Streamed variant: align_step section by section; the first step
  # compiles, the second runs warm.
  solved = jnp.zeros((2, 1, n // cfg.stride, n // cfg.stride), jnp.float32)
  step_errs, step_s, step_overflow = [], [], False
  for z in range(1, min(3, n_z)):
    (solved, rendered_z, ov), secs = _timed(
        lambda: stack_align.align_step(stack[z - 1], stack[z], solved, cfg))
    step_s.append(secs)
    step_errs.append(float(jnp.mean(jnp.abs(
        rendered_z[inter] - stack[0][inter].astype(jnp.float32)))))
    step_overflow |= bool(ov)

  metrics = dict(sections=n_z, size=n, first_call_s=first_s, warm_s=warm_s,
                 compile_s=first_s - warm_s,
                 mpix_per_s=(n_z - 1) * n * n / warm_s / 1e6,
                 max_err=float(errs.max()), raw_err=raw_err,
                 overflow=bool(overflow), step_first_call_s=step_s[0],
                 step_warm_s=step_s[-1], step_max_err=max(step_errs), step_overflow=step_overflow,
                 peak_bytes=_peak_bytes())
  _gate(not metrics['overflow'], 'align_stack overflowed its envelope')
  _gate(metrics['max_err'] <= 3.5,
        f'worst-section error {metrics["max_err"]} > 3.5')
  _gate(not step_overflow, 'align_step overflowed its envelope')
  _gate(metrics['step_max_err'] <= 3.5,
        f'align_step error {metrics["step_max_err"]} > 3.5')
  return metrics


def phase_ops(n=10000, pair=1024, mesh_n=250, render_rows=1024, seed=1):
  """Each device op at full width vs its plain reference."""
  cpu = jax.devices('cpu')[0]
  key = jax.random.PRNGKey(seed)
  pre = texture(key, (n, n))
  metrics = {}

  # 1. Targeted fine pass vs the untargeted dense grid on an integer-
  # shifted pair: per-node offsets = the true shift + random jitter.
  shift = (7, -12)
  post = jnp.roll(pre, shift, (0, 1))
  step, fine = (40, 40), (80, 80)
  def untargeted():
    return flow_field.dense_flow_field(pre, post, fine, step, circular=True,
                                       dft_matmul=True, bf16=True)

  _timed(untargeted)
  ref, untargeted_s = _timed(untargeted)
  grid = ref.shape[1:]
  offs = (jnp.asarray(shift, jnp.int32)
          + jax.random.randint(key, grid + (2,), -3, 4, jnp.int32))

  def targeted():
    return flow_field.targeted_flow_peaks(pre, post, offs, fine, step,
                                          max_offset=16, bf16=True)

  _timed(targeted)
  got, targeted_s = _timed(targeted)
  ref, got, offs = np.asarray(ref), np.asarray(got), np.asarray(offs)
  abs_x = (got[0] - offs[..., 1])[2:-2, 2:-2]
  abs_y = (got[1] - offs[..., 0])[2:-2, 2:-2]
  ref_x, ref_y = ref[0][2:-2, 2:-2], ref[1][2:-2, 2:-2]
  valid = np.isfinite(abs_x) & np.isfinite(ref_x)
  metrics['targeted_agree'] = float(np.mean(
      (abs_x == ref_x)[valid] & (abs_y == ref_y)[valid]))
  metrics['targeted_valid'] = float(valid.mean())
  metrics['targeted_s'] = targeted_s
  metrics['untargeted_s'] = untargeted_s
  _gate(metrics['targeted_valid'] > 0.9, 'targeted pass lost its peaks')
  _gate(metrics['targeted_agree'] >= 0.999,
        f'targeted peaks agree on {metrics["targeted_agree"]} < 0.999')

  # 2. Lanczos gather render: card vs CPU on the same coordinates.
  s = 40
  g = n // s
  my, mx = np.mgrid[:g, :g].astype(np.float32)
  wav = 2000.0 / s
  inv_abs = jnp.asarray(np.stack([
      mx * s - 12.0 + 12.0 * np.sin(2 * np.pi * my / wav),
      my * s + 7.0 + 12.0 * np.cos(2 * np.pi * mx / wav)]))
  coords = jax.block_until_ready(interp.upsample_map_linear(
      jnp.stack([inv_abs[1], inv_abs[0]]), s, (0, 0), (n, n)))
  render = functools.partial(interp.sample, method='lanczos',
                             mode='constant', cval=0.0)
  warped, _ = _timed(lambda: render(pre, coords))
  warped, render_s = _timed(lambda: render(pre, coords))
  r0 = n // 2 - render_rows // 2
  strip = np.asarray(warped[r0:r0 + render_rows])
  with jax.default_device(cpu):
    ref_strip = np.asarray(render(
        jax.device_put(pre, cpu),
        jax.device_put(coords[:, r0:r0 + render_rows], cpu)))
  diff = np.abs(strip - ref_strip)
  metrics.update(render_s=render_s, render_max_diff=float(diff.max()),
                 render_mean_diff=float(diff.mean()))
  _gate(metrics['render_max_diff'] <= 1e-2,
        f'render max diff {metrics["render_max_diff"]} > 1e-2')
  _gate(metrics['render_mean_diff'] <= 1e-4,
        f'render mean diff {metrics["render_mean_diff"]} > 1e-4')

  # 3. Fused FIRE solve vs the staged solver on a section-sized mesh.
  cfg = stack_align.StackAlignConfig().mesh
  rng = np.random.RandomState(seed)
  gy, gx = np.mgrid[:mesh_n, :mesh_n].astype(np.float32)
  prev = np.stack([5.0 * np.sin(gy / 17.0) + rng.randn(mesh_n, mesh_n),
                   4.0 * np.cos(gx / 23.0) + rng.randn(mesh_n, mesh_n)])
  prev = prev[:, None].astype(np.float32)
  prev[:, :, :2] = prev[:, :, -2:] = np.nan
  prev[:, :, :, :2] = prev[:, :, :, -2:] = np.nan
  prev = jnp.asarray(prev)
  x0 = jnp.where(jnp.isnan(prev), 0.0, prev)
  (fused, _, steps), _ = _timed(lambda: mesh.relax_mesh_fused(x0, prev, cfg))
  (fused, _, steps), fused_s = _timed(
      lambda: mesh.relax_mesh_fused(x0, prev, cfg))
  staged, _, staged_steps = mesh.relax_mesh(x0, prev, cfg)
  delta = float(jnp.nanmax(jnp.abs(fused - staged)))
  metrics.update(relax_fused_s=fused_s, relax_steps=int(steps),
                 relax_staged_steps=int(staged_steps),
                 relax_steps_per_s=int(steps) / fused_s,
                 relax_max_delta=delta)
  _gate(bool(jnp.all(jnp.isnan(fused) == jnp.isnan(staged))),
        'fused and staged solves disagree on missing nodes')
  _gate(delta <= 0.01 * cfg.stride[0],
        f'fused vs staged max node delta {delta} > {0.01 * cfg.stride[0]}')

  # 4. float32 flow: card vs CPU on a smoothly deformed pair.
  pre_p = texture(jax.random.PRNGKey(seed + 1), (pair, pair))
  disp = 6.0 * np.sin(np.mgrid[:pair // s, :pair // s] / 3.0)
  post_p = deform(pre_p, jnp.asarray(disp, jnp.float32), s)
  flow32 = functools.partial(
      flow_field.dense_flow_field, patch_size=(160, 160), step=(s, s),
      circular=True, dft_matmul=True, bf16=False)
  dev = np.asarray(flow32(pre_p, post_p))
  with jax.default_device(cpu):
    host = np.asarray(flow32(jax.device_put(pre_p, cpu),
                             jax.device_put(post_p, cpu)))
  same = np.nan_to_num(dev[:2], nan=9e9) == np.nan_to_num(host[:2], nan=9e9)
  metrics['f32_flow_agree'] = float(same.mean())
  _gate(same.all(), f'f32 flow peaks differ from the CPU on '
        f'{int((~same).sum())} entries')
  metrics['peak_bytes'] = _peak_bytes()
  return metrics


def phase_montage(grid=3, tile=3600, overlap=400, stride=40, patch=160,
                  coarse_overlaps=(360, 440), min_overlap=200, margin=16,
                  flow_batch=256, seed=2):
  """pipeline.montage on a grid x grid tile montage of one texture."""
  step_t = tile - overlap
  n_m = step_t * (grid - 1) + tile
  img = texture(jax.random.PRNGKey(seed), (n_m, n_m))
  tiles = {(tx, ty): img[ty * step_t:ty * step_t + tile,
                         tx * step_t:tx * step_t + tile]
           for ty in range(grid) for tx in range(grid)}
  cfg = montage.MontageConfig(
      stride=stride, patch_size=patch, coarse_overlaps=coarse_overlaps,
      min_overlap=min_overlap, margin=margin, flow_batch=flow_batch,
      mesh_cfg=mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.01, k=0.1,
          stride=(float(stride), float(stride)), num_iters=1000,
          max_iters=20000, stop_v_max=0.005, dt_max=100.0))

  def run():
    return montage.montage_align_2d(tiles, (grid, grid), cfg)

  out, first_s = _timed(run)
  out, warm_s = _timed(run)
  solved, key_to_idx = out['solved'], out['key_to_idx']
  # Compare modulo the solver's global-translation gauge.
  sx = int(round(float(solved[0, key_to_idx[(0, 0)], 0, 0])))
  sy = int(round(float(solved[1, key_to_idx[(0, 0)], 0, 0])))
  lo, hi = tile // 4, n_m - tile // 4
  c = out['canvas'][lo + sy:hi + sy, lo + sx:hi + sx]
  m = out['mask'][lo + sy:hi + sy, lo + sx:hi + sx]
  truth = img[lo:hi, lo:hi]
  cnt = jnp.sum(m)
  err = float(jnp.sum(jnp.where(m, jnp.abs(c - truth), 0.0))
              / jnp.maximum(cnt, 1))
  metrics = dict(grid=grid, tile=tile, first_call_s=first_s,
                 warm_s=warm_s, mpix_per_s=n_m * n_m / warm_s / 1e6,
                 err=err, coverage=float(cnt / truth.size),
                 overflow=bool(out['overflow']), peak_bytes=_peak_bytes())
  _gate(metrics['err'] <= 10.0, f'montage error {metrics["err"]} > 10')
  _gate(metrics['coverage'] >= 0.95,
        f'montage coverage {metrics["coverage"]} < 0.95')
  return metrics


def phase_stitch3d(depth=64, tile=576, overlap=64, stride=16, patch=32,
                   margin=8, flow_batch=64, trim=(8, 16), seed=3):
  """pipeline.stitch3d on a 2 x 2 grid of volumetric tiles."""
  step_t = tile - overlap
  n3 = step_t + tile
  vol = texture(jax.random.PRNGKey(seed), (depth, n3, n3), sigma=0.12)
  dev_tiles = {(tx, ty): vol[:, ty * step_t:ty * step_t + tile,
                             tx * step_t:tx * step_t + tile]
               for ty in range(2) for tx in range(2)}
  tiles = {k: np.asarray(v) for k, v in dev_tiles.items()}
  stride3 = (stride,) * 3
  cfg = stitch3d.Stitch3dConfig(
      stride=stride3, patch_size=(patch,) * 3, flow_batch=flow_batch,
      margin=margin,
      mesh_cfg=mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.01, k=0.1,
          stride=tuple(float(v) for v in stride3), num_iters=400,
          max_iters=10000, stop_v_max=0.005, dt_max=100.0))
  # Coarse offsets (xyz channels): x-pairs overlap in x, y-pairs in y.
  cx = np.full((3, 1, 2, 2), np.nan)
  cx[:, 0, :, 0] = np.array([-overlap, 0.0, 0.0])[:, None]
  cy = np.full((3, 1, 2, 2), np.nan)
  cy[:, 0, 0, :] = np.array([0.0, -overlap, 0.0])[:, None]
  coarse = np.zeros((3, 1, 2, 2), np.float32)
  for ty in range(2):
    for tx in range(2):
      coarse[0, 0, ty, tx] = -overlap * tx
      coarse[1, 0, ty, tx] = -overlap * ty

  def run():
    return stitch3d.stitch_and_render_3d(tiles, cx, cy, coarse, cfg,
                                         device_tiles=dev_tiles)

  out, first_s = _timed(run)
  out, warm_s = _timed(run)
  lz, lyx = trim
  sl = np.s_[lz:depth - lz, lyx:n3 - lyx, lyx:n3 - lyx]
  truth = vol[sl]
  m = out['weights'][sl] > 0
  cnt = jnp.sum(m)
  rel = float(jnp.sum(jnp.where(m, jnp.abs(out['canvas'][sl] - truth), 0.0))
              / jnp.maximum(cnt, 1) / jnp.std(truth))
  metrics = dict(depth=depth, tile=tile, first_call_s=first_s,
                 warm_s=warm_s,
                 mvox_per_s=depth * n3 * n3 / warm_s / 1e6, rel_err=rel,
                 coverage=float(cnt / truth.size),
                 solve_steps=int(out['solve_steps']),
                 peak_bytes=_peak_bytes())
  _gate(metrics['rel_err'] <= 0.5,
        f'stitch3d relative error {metrics["rel_err"]} > 0.5')
  _gate(metrics['coverage'] >= 0.5,
        f'stitch3d coverage {metrics["coverage"]} < 0.5')
  return metrics


def phase_api(n=4096):
  """README quick-start chain (examples/e2e_alignment.py PASS rule)."""
  t0 = time.perf_counter()
  result = align_pair(n, log=lambda msg: print(msg, file=sys.stderr))
  result['seconds'] = time.perf_counter() - t0
  _gate(result['ok'], f'quick-start chain failed its PASS rule: {result}')
  return result


def phase_multichip(n=10000, mesh_n=256, seed=4):
  """Sharded solve (1x4, 2x2) and sharded flow vs one device."""
  _gate(len(jax.devices()) >= 4,
        f'--multichip needs 4 devices, found {len(jax.devices())}')
  metrics = {}
  cfg = stack_align.StackAlignConfig().mesh
  rng = np.random.RandomState(seed)
  gy, gx = np.mgrid[:mesh_n, :mesh_n].astype(np.float32)
  prev = np.stack([5.0 * np.sin(gy / 17.0) + rng.randn(mesh_n, mesh_n),
                   4.0 * np.cos(gx / 23.0) + rng.randn(mesh_n, mesh_n)])
  prev = jnp.asarray(prev[:, None].astype(np.float32))
  x0 = jnp.zeros_like(prev)
  single, _, _ = mesh.relax_mesh_fused(x0, prev, cfg)
  for name, dmesh in (('1x4', mesh_sharding.make_mesh(4)),
                      ('2x2', mesh_sharding.make_mesh_2d(2, 2))):
    (out, _, steps), secs = _timed(
        lambda: mesh_sharding.relax_mesh_sharded(x0, prev, cfg, dmesh))
    delta = float(jnp.max(jnp.abs(out - single)))
    metrics[f'relax_{name}_max_delta'] = delta
    metrics[f'relax_{name}_first_call_s'] = secs
    _gate(delta <= 0.01 * cfg.stride[0],
          f'sharded relax {name} differs by {delta} px')

  # The sharded flow needs the height divisible by the device count and
  # each strip by the stride: pad the section to a multiple of 4 * 40.
  n_pad = -(-n // 160) * 160
  pre = texture(jax.random.PRNGKey(seed), (n_pad, n_pad))
  post = jnp.roll(pre, (7, -12), (0, 1))
  kw = dict(circular=True, dft_matmul=True, bf16=True)
  ref = np.asarray(flow_field.dense_flow_field(pre, post, (160, 160),
                                               (40, 40), batch_size=256,
                                               **kw))
  got, secs = _timed(lambda: mesh_sharding.dense_flow_field_sharded(
      mesh_sharding.make_mesh(4), pre, post, (160, 160), (40, 40),
      batch_size=256, **kw))
  got = np.asarray(got)
  same = (np.nan_to_num(got[:2], nan=9e9)
          == np.nan_to_num(ref[:2], nan=9e9))
  metrics['flow_sharded_first_call_s'] = secs
  metrics['flow_sharded_agree'] = float(same.mean())
  _gate(got.shape == ref.shape and same.all(),
        'sharded flow peaks differ from the single-device result')
  return metrics


def _gpu_lines():
  try:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=False)
  except (OSError, subprocess.TimeoutExpired) as e:
    return [f'nvidia-smi unavailable: {e}']
  return [line for line in out.stdout.splitlines() if line.strip()] or [
      f'nvidia-smi gave no output: {out.stderr.strip()}']


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--multichip', action='store_true',
                      help='run only the four-device sharded paths')
  args = parser.parse_args(argv)

  for line in _gpu_lines():
    print(line, flush=True)
  platforms = jax.config.jax_platforms
  if platforms and 'cpu' not in platforms.split(','):
    # The CPU backend holds the plain references of the ops phase.
    jax.config.update('jax_platforms', platforms + ',cpu')
  if jax.default_backend() != 'gpu':
    print(f'chip_smoke: no GPU (JAX backend {jax.default_backend()!r})',
          file=sys.stderr)
    return 1
  enable_compile_cache()

  if args.multichip:
    phases = [('multichip', phase_multichip)]
  else:
    phases = [('stack', phase_stack), ('ops', phase_ops),
              ('montage', phase_montage), ('stitch3d', phase_stitch3d),
              ('api', phase_api)]
  failed = []
  for name, fn in phases:
    t0 = time.perf_counter()
    try:
      metrics = fn()
    except Exception:  # noqa: BLE001 - report every phase, then fail
      traceback.print_exc()
      failed.append(name)
      print(f'[{name}] FAILED after {time.perf_counter() - t0:.1f} s',
            flush=True)
      continue
    metrics['phase_s'] = time.perf_counter() - t0
    print(f'[{name}] {json.dumps(metrics)}', flush=True)
  if failed:
    print(f'chip_smoke: failed phases: {failed}', file=sys.stderr)
    return 1

  dev = jax.devices()[0]
  print(json.dumps({'ok': True, 'device': {
      'platform': dev.platform, 'kind': dev.device_kind,
      'count': len(jax.devices())}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
