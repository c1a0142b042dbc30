"""Benchmark: flow+warp throughput on a 10k² EM section + mesh rates.

Runs on one GPU (exits non-zero when JAX finds none) and prints ONE JSON
line:
  {"metric": ..., "value": N, "unit": "Mpix/s", "vs_baseline": N, ...}
with the device it ran on (platform, kind, count) and the XLA flags.

Design note: all headline stages are DEVICE-RESIDENT — inputs go
host->device once and every timed region ends in block_until_ready;
bulk d2h is deliberately excluded from the measured path. The
EstimateMissingFlow stage is host-orchestrated by design (like the
reference's) and is reported for regression tracking only.

Run:  python bench.py   (compile cache: $JAX_COMPILATION_CACHE_DIR, else
                         .jax_cache in the checkout)

Honesty notes:
  * the warp stage uses a SMOOTH deformation field (amplitude 12 px,
    like examples/e2e_alignment.py), not a pure translation;
  * flow runs bf16 only after asserting integer-peak parity with f32 on
    the benchmark data itself.

Baselines (BASELINE.md):
  * north star: >1 Gpix/s/chip combined flow+warp on a 10k² section
    (vs_baseline = value / 1000)
  * mesh relaxation: 2.3 GLUPS (reference GPU figure, mesh.py comment)
"""

import json
import sys
import time

import numpy as np


def _time(fn, repeats=3):
  """Warmup + median-of-N wall time for a device computation.

  Each timed call ends in block_until_ready on every output leaf.
  Returns (out, median_seconds, spread_seconds).
  """
  import jax

  out = jax.block_until_ready(fn())
  times = []
  for _ in range(repeats):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    times.append(time.perf_counter() - t0)
  times.sort()
  return out, times[len(times) // 2], times[-1] - times[0]


_T0 = time.perf_counter()


def _progress(msg):
  """Per-stage heartbeat on stderr (stdout carries ONLY the JSON line).

  The heartbeat makes a long run diagnosable and attributes the time
  per stage."""
  print(f'[bench +{time.perf_counter() - _T0:7.1f}s] {msg}',
        file=sys.stderr, flush=True)


def _guard(results, name, fn):
  """Stage isolation: one failing stage must not erase the whole run's
  numbers (the JSON line is printed once at the end)."""
  _progress(f'stage {name} ...')
  try:
    fn()
  except Exception as e:  # noqa: BLE001 - record and continue
    results[name + '_error'] = f'{type(e).__name__}: {e}'[:300]
    _progress(f'stage {name} FAILED: {results[name + "_error"]}')


def main():
  import os

  import jax
  if jax.default_backend() != 'gpu':
    print(f'bench: no GPU (JAX backend {jax.default_backend()!r})',
          file=sys.stderr)
    return 1
  from chip_smoke import deform, enable_compile_cache
  enable_compile_cache()
  import jax.numpy as jnp
  from sofima_tpu import flow_field, mesh

  n = 10000
  stride = 40
  patch = 160
  rng = np.random.RandomState(0)

  # Band-limited texture (EM-like) so correlation peaks are realistic.
  noise = rng.rand(n, n).astype(np.float32)
  f = np.fft.rfft2(noise)
  fy = np.fft.fftfreq(n)[:, None]
  fx = np.fft.rfftfreq(n)[None, :]
  f *= np.exp(-((fx**2 + fy**2) / (2 * 0.08**2)))
  pre_np = np.fft.irfft2(f, s=(n, n)).astype(np.float32)
  pre_np = (pre_np - pre_np.min()) / np.ptp(pre_np) * 255.0
  post_np = np.roll(pre_np, (7, -12), (0, 1))

  pre = jax.device_put(pre_np)
  post = jax.device_put(post_np)

  results = {}

  # ---- FLOW: dense grid over the full 10k^2 pair (device resident). ------
  _progress('stage flow ...')
  def run_flow_padfield():
    return flow_field.dense_flow_field(pre, post, (patch, patch),
                                       (stride, stride), batch_size=512)

  flow, t_flow_padfield, sp_flow_padfield = _time(run_flow_padfield)
  grid = flow.shape[1:]
  results['flow_s_padfield'] = round(t_flow_padfield, 3)
  results['flow_s_padfield_spread_s'] = round(sp_flow_padfield, 3)

  # Production dense-grid mode: strip-sliced patches + DFT-matmul
  # correlation; bf16 matmul inputs gated on f32 parity.
  def run_flow(bf16):
    return flow_field.dense_flow_field(pre, post, (patch, patch),
                                       (stride, stride), batch_size=256,
                                       circular=True, dft_matmul=True,
                                       bf16=bf16)

  flow_f32, t_flow_f32, _sp = _time(lambda: run_flow(False))
  flow_b16, t_flow_b16, _sp = _time(lambda: run_flow(True))
  # Integer-peak parity gate (device-side reduction, scalar fetch).
  agree = float(jnp.mean(
      jnp.nan_to_num(flow_f32[0]) == jnp.nan_to_num(flow_b16[0])))
  results['flow_bf16_peak_agreement'] = round(agree, 5)
  if agree >= 0.999:
    flow, t_flow = flow_b16, t_flow_b16
    results['flow_mode'] = 'circular_dft_bf16'
  else:
    flow, t_flow = flow_f32, t_flow_f32
    results['flow_mode'] = 'circular_dft'
  results['flow_s_f32'] = round(t_flow_f32, 3)
  med_x = float(jnp.nanmedian(flow[0]))
  med_y = float(jnp.nanmedian(flow[1]))
  results['flow_s'] = round(t_flow, 3)
  results['flow_patches'] = int(np.prod(grid))
  results['flow_median_xy'] = [med_x, med_y]

  # MASKED flow (the production EM regime): Padfield NCC with a
  # realistic tissue mask (diagonal crack band + a blob, ~17% invalid).
  yy, xx = np.mgrid[:n, :n]
  mask_np = (((yy + xx) % 7919 < 900)
             | (((yy - 3000)**2 + (xx - 7000)**2) < 1500**2))
  mask = jax.device_put(mask_np)
  del yy, xx

  def run_flow_masked(bf16):
    return flow_field.dense_flow_field(
        pre, post, (patch, patch), (stride, stride), batch_size=256,
        circular=True, dft_matmul=True, bf16=bf16,
        pre_mask=mask, post_mask=mask)

  # bf16 request (the masked NCC terms stay float32), gated on
  # integer-peak agreement with the f32 run.
  flow_m32, t_flow_m32, _sp = _time(lambda: run_flow_masked(False))
  flow_m16, t_flow_m16, _sp = _time(lambda: run_flow_masked(True))
  agree_m = float(jnp.mean(
      jnp.nan_to_num(flow_m32[0], nan=9e9)
      == jnp.nan_to_num(flow_m16[0], nan=9e9)))
  results['flow_masked_bf16_peak_agreement'] = round(agree_m, 5)
  results['flow_masked_s_f32'] = round(t_flow_m32, 3)
  if agree_m >= 0.9995:
    flow_m, t_flow_m = flow_m16, t_flow_m16
    results['flow_masked_mode'] = 'bf16_split'
  else:
    flow_m, t_flow_m = flow_m32, t_flow_m32
    results['flow_masked_mode'] = 'f32'
  results['flow_masked_s'] = round(t_flow_m, 3)
  results['flow_masked_valid_frac'] = round(
      float(jnp.mean(jnp.isfinite(flow_m[0]))), 3)

  # ---- WARP: Lanczos4 render of the full section under a SMOOTH map. -----
  _progress('stage warp ...')
  # Inverse map: the +(7,-12) roll undone, plus a smooth sinusoidal
  # deformation with 12 px amplitude (a realistic alignment field).
  grid_n = n // stride
  my, mx = np.mgrid[:grid_n, :grid_n].astype(np.float32)
  amp = 12.0
  wav = 2000.0 / stride
  dx = -12.0 + amp * np.sin(2 * np.pi * my / wav)
  dy = 7.0 + amp * np.cos(2 * np.pi * mx / wav)
  abs_map = np.zeros((1, 2, grid_n, grid_n), np.float32)
  abs_map[:, 0] = dx + mx * stride
  abs_map[:, 1] = dy + my * stride

  from sofima_tpu.ops import interp, shift_warp

  abs_map_j = jax.device_put(abs_map[0])
  dense_w = jax.block_until_ready(interp.upsample_map_linear(
      abs_map_j, stride, (0, 0), (n, n)))
  coords_w = jnp.stack([dense_w[1], dense_w[0]])
  del dense_w

  # The render: the gather sampler (every render phase uses it).
  def run_warp():
    return interp.sample(post, coords_w, method='lanczos', mode='constant',
                         cval=0.0)

  warped, t_warp, _sp = _time(run_warp)
  results['warp_s'] = round(t_warp, 4)

  # Conservative composition: dense-grid flow + exact render, timed as
  # separate dispatches (the round-1..4 "combined" metric; kept for
  # regression tracking). The HEADLINE combined metric is the fused
  # production chain measured below (combined_mpix_s) — see BASELINE.md
  # "Metric decision".
  mpix_s = (n * n) / (t_flow + t_warp) / 1e6
  results['combined_dense_mpix_s'] = round(mpix_s, 1)

  # ---- COMBINED (headline): fused single-pair flow+warp chain. -----------
  # The production shape of "combined flow+warp on one 10k^2 pair": ONE
  # jit program runs coarse-to-fine flow -> clean -> harmonic fill ->
  # device envelope plan -> Lanczos gather render — i.e. the
  # EstimateFlow -> WarpByMap chain with the flow-negation inverse-map
  # approximation in place of a mesh solve (2nd-order exact for smooth
  # fields; the pipeline stage below covers the exact solver+inversion
  # path). The pair is (pre, warped): `warped` is post resampled under
  # the smooth 12 px sinusoidal field, so the TRUE pre->warped flow is
  # that sinusoid — the chain must measure it and render `warped` back
  # onto `pre`, which gives a hard ground-truth quality gate.
  def stage_combined_fused():
    from sofima_tpu import flow_utils
    from sofima_tpu.ops import fill as fill_ops
    warped_img = warped
    res_c = 8
    node_np = np.arange(grid_n, dtype=np.float64) * stride
    pad = patch // 2 // stride

    @jax.jit
    def combined(a, b):
      f4, ov1 = flow_field.coarse_to_fine_flow(
          a, b, (patch, patch), (stride, stride), bf16=True,
          max_displacement=64, residual=res_c, peak_crop=32,
          return_overflow=True)
      clean = flow_utils.clean_flow_device(f4[:, None], 1.6, 1.6, 80.0,
                                           20.0)
      gfull = jnp.full((2, 1, grid_n, grid_n), jnp.nan, jnp.float32)
      gfull = jax.lax.dynamic_update_slice(gfull, clean, (0, 0, pad, pad))
      valid = jnp.isfinite(gfull[0, 0]) & jnp.isfinite(gfull[1, 0])
      grel = fill_ops.fill_invalid(gfull[:, 0], valid, extrapolate=True)
      inv_y = -grel[1]
      inv_x = -grel[0]
      env_r = (-res_c, res_c, -res_c, res_c)
      env_b = (-64, 64, -64, 64)
      dplan = shift_warp.tiled_plan_device(
          inv_y[None], inv_x[None], node_np, node_np, (n, n), env_r,
          env_b)
      node = jnp.arange(grid_n, dtype=jnp.float32) * stride
      dense = interp.upsample_map_linear(
          jnp.stack([inv_y + node[:, None], inv_x + node[None, :]]),
          stride, (0, 0), (n, n))
      rendered = interp.sample(b, dense, method='lanczos',
                               mode='constant', cval=0.0)
      return rendered, ov1 | dplan['overflow']

    (rend_c, ovf_c), t_cf, sp_cf = _time(
        lambda: combined(pre, warped_img))
    inter_c = np.s_[256:-256, 256:-256]
    err_c = float(jnp.mean(jnp.abs(rend_c[inter_c] - pre[inter_c])))
    results['combined_s'] = round(t_cf, 3)
    results['combined_spread_s'] = round(sp_cf, 3)
    results['combined_mpix_s'] = round((n * n) / t_cf / 1e6, 1)
    results['combined_err'] = round(err_c, 3)
    results['combined_overflow'] = bool(ovf_c)

  _guard(results, 'combined', stage_combined_fused)

  # ---- 3D RENDER: shift-decomposed trilinear warp (StitchAndRender path).
  _progress('stage warp3d ...')
  vol = jax.device_put(rng.rand(64, 1024, 1024).astype(np.float32))
  zz, yy, xx = np.mgrid[0:64, 0:1024, 0:1024].astype(np.float32)
  c3 = np.stack([
      zz + 2.0 * np.sin(2 * np.pi * yy / 512),
      yy + 6.0 * np.cos(2 * np.pi * xx / 512),
      xx + 6.0 * np.sin(2 * np.pi * zz / 64),
  ])
  coords3 = jax.device_put(c3)
  del zz, yy, xx, c3

  def run_warp3d():
    # Trilinear gather: the 3d render of pipeline.stitch3d.
    return interp.sample(vol, coords3, method='linear', mode='constant',
                         cval=0.0)

  _, t_w3, _sp = _time(run_warp3d)
  results['warp3d_s'] = round(t_w3, 4)
  results['warp3d_mvox_s'] = round(64 * 1024 * 1024 / t_w3 / 1e6, 1)

  # ---- FLOW 3D: LICONN fine-stitching overlap pair. ----------------------
  # Circular strip path (one device program, gather-free patch assembly)
  # vs the scattered-start padfield driver on a tile-overlap-sized crop.
  def stage_flow3d():
    # 64 z-planes of EM-like texture (staggered crops of the section).
    vol3a = jax.device_put(np.ascontiguousarray(
        np.stack([pre_np[i * 7:i * 7 + 480, :160]
                  for i in range(64)])).astype(np.float32))
    vol3b = jnp.roll(vol3a, (2, -3, 4), (0, 1, 2))
    patch3, step3 = (40, 80, 80), (8, 40, 40)

    def run_flow3d():
      return flow_field.dense_flow_field(vol3a, vol3b, patch3, step3,
                                         circular=True)

    f3, t_f3, _sp = _time(run_flow3d)
    results['flow3d_s'] = round(t_f3, 3)
    results['flow3d_grid'] = list(int(v) for v in f3.shape[1:])
    mfc3 = flow_field.JAXMaskedXCorrWithStatsCalculator()
    # Median of 3 with spread: the host-batched driver syncs per batch.
    vol3a_np, vol3b_np = np.asarray(vol3a), np.asarray(vol3b)
    t3_ref_all = []
    for _ in range(3):
      t0 = time.perf_counter()
      f3_ref = mfc3.flow_field(vol3a_np, vol3b_np, patch_size=patch3,
                               step=step3, batch_size=32)
      t3_ref_all.append(time.perf_counter() - t0)
    t3_ref_all.sort()
    results['flow3d_padfield_s'] = round(t3_ref_all[1], 3)
    results['flow3d_padfield_spread_s'] = round(
        t3_ref_all[-1] - t3_ref_all[0], 3)
    agree3 = float(np.mean(
        np.nan_to_num(np.asarray(f3)[:3], nan=9e9)
        == np.nan_to_num(f3_ref[:3], nan=9e9)))
    results['flow3d_peak_agreement'] = round(agree3, 5)

    # MASKED 3d flow (the LICONN production regime): the dim-generic
    # circular Padfield NCC on the same strip path — previously a
    # NotImplementedError cliff onto the 3.2 s padfield driver.
    mask3_np = np.zeros((64, 480, 160), bool)
    mask3_np[:, 0:480:7, :] = True  # ~14% invalid, striped
    mask3 = jax.device_put(mask3_np)

    def run_flow3d_masked():
      return flow_field.dense_flow_field(vol3a, vol3b, patch3, step3,
                                         circular=True, pre_mask=mask3,
                                         post_mask=mask3)

    f3m, t_f3m, _sp = _time(run_flow3d_masked)
    results['flow3d_masked_s'] = round(t_f3m, 3)
    results['flow3d_masked_valid_frac'] = round(
        float(jnp.mean(jnp.isfinite(f3m[0]))), 3)

  _guard(results, 'flow3d', stage_flow3d)

  # ---- PIPELINE: streamed z-stack alignment. -----------------------------
  _progress('stage pipeline ...')
  # The production metric: 16 sections of 10k^2 streamed through the
  # FUSED per-section chain (coarse-to-fine flow -> clean -> mesh solve
  # -> invert -> Lanczos render; pipeline.stack_align.align_step, one
  # jit program per section, zero host round trips). Sections are
  # generated on device from the base texture with known smooth
  # deformations (cumulative drift + wobble), so alignment quality is
  # gated against ground truth below.
  from sofima_tpu.pipeline import stack_align

  n_z = 16
  grid_n_p = n // stride
  base_u8 = jnp.clip(post + 0.5, 0, 255).astype(jnp.uint8)
  gm_y, gm_x = np.mgrid[:grid_n_p, :grid_n_p].astype(np.float32) * stride
  stack_list = [base_u8]
  for z in range(1, n_z):
    dyz = 2.5 * z + 7.0 * np.sin(2 * np.pi * gm_x / 2500.0 + 0.7 * z)
    dxz = -2.0 * z + 7.0 * np.cos(2 * np.pi * gm_y / 2500.0 + 0.4 * z)
    stack_list.append(deform(base_u8.astype(jnp.float32),
                             jax.device_put(np.stack([dyz, dxz])), stride))

  # Levers carried over from the first hardware's ablations, not yet
  # re-ablated on this card: residual=6 (a tight envelope for the
  # overflow check), num_iters=125 solve chunks (the on-device
  # while_loop exits at the first converged boundary), peak_crop=32
  # (fine peak search in the centered 32^2 correlation core), and
  # warm_start off (the z-batched cold passes; align_step covers the
  # streamed mode below).
  import dataclasses as _dc_cfg
  pcfg = stack_align.StackAlignConfig(max_displacement=128, residual=6,
                                      peak_crop=32, warm_start=False)
  pcfg = _dc_cfg.replace(pcfg, mesh=_dc_cfg.replace(pcfg.mesh,
                                                    num_iters=125))
  grid_nn = n // pcfg.stride
  stack_j = jnp.stack(stack_list)
  del stack_list, base_u8
  inter = np.s_[320:-320, 320:-320]

  def run_pipeline():
    rendered, _, overflow = stack_align.align_stack_pipelined(
        stack_j, pcfg, out_dtype=jnp.uint8)

    # Per-section stats WITHOUT materializing an f32 render stack
    # (15 x 400 MB of f32 sections OOM'd the ablation runs): lax.map
    # keeps one f32 section transient at a time.
    def stats_one(r_u8):
      r = r_u8.astype(jnp.float32)
      base_i = stack_j[0][inter].astype(jnp.float32)
      return (jnp.sum(r[::97, ::97]),
              jnp.mean(jnp.abs(r[inter] - base_i)))

    sums, errs = jax.lax.map(stats_one, rendered[1:])
    return jnp.sum(sums), jnp.max(errs), overflow

  t0 = time.perf_counter()
  jax.block_until_ready(run_pipeline())  # compile + warmup
  results['pipeline_first_call_s'] = round(time.perf_counter() - t0, 3)
  times = []
  for _ in range(3):
    t0 = time.perf_counter()
    acc, err_acc, overflow = jax.block_until_ready(run_pipeline())
    times.append(time.perf_counter() - t0)
  results['pipeline_peak_bytes'] = (
      jax.local_devices()[0].memory_stats() or {}).get('peak_bytes_in_use')
  t_pipe = sorted(times)[1]
  pipe_mpix = (n_z - 1) * n * n / t_pipe / 1e6
  results['pipeline_s'] = round(t_pipe, 3)
  results['pipeline_times_s'] = [round(t, 3) for t in times]
  results['pipeline_sections'] = n_z - 1
  results['pipeline_mpix_s'] = round(pipe_mpix, 1)
  results['pipeline_overflow'] = bool(overflow)
  # Quality: worst per-section mean |rendered - base| over the interior;
  # raw (unaligned) neighbors differ by ~20+ gray levels at this drift.
  results['pipeline_max_err'] = round(float(err_acc), 2)
  raw_err = float(jnp.mean(jnp.abs(
      stack_j[n_z - 1][inter].astype(jnp.float32)
      - stack_j[0][inter].astype(jnp.float32))))
  results['pipeline_raw_err'] = round(raw_err, 2)

  # Streamed per-section variant (the incremental-arrival mode) for
  # regression tracking of the align_step path.
  def stage_pipeline_stepwise():
    pcfg_s = stack_align.StackAlignConfig(max_displacement=128,
                                          residual=8)
    solved0 = jnp.zeros((2, 1, grid_nn, grid_nn), jnp.float32)

    def run_stepwise():
      solved_z = solved0
      acc = jnp.float32(0.0)
      ovf = jnp.bool_(False)
      for z in range(1, n_z):
        solved_z, rendered_z, ov = stack_align.align_step(
            stack_j[z - 1], stack_j[z], solved_z, pcfg_s)
        acc = acc + jnp.sum(rendered_z[::97, ::97])
        ovf = jnp.logical_or(ovf, ov)
      return acc, ovf

    jax.block_until_ready(run_stepwise())
    ts = []
    for _ in range(3):
      t0 = time.perf_counter()
      jax.block_until_ready(run_stepwise())
      ts.append(time.perf_counter() - t0)
    results['pipeline_stepwise_s'] = round(sorted(ts)[1], 3)
    results['pipeline_stepwise_mpix_s'] = round(
        (n_z - 1) * n * n / sorted(ts)[1] / 1e6, 1)

  _guard(results, 'pipeline_stepwise', stage_pipeline_stepwise)

  # Envelope-relaxed variant (informational): residual=4 + 250-iter
  # solve chunks; its envelope check flags overflow on a few border
  # tiles, so it stays off the gated headline.
  def stage_pipeline_tight():
    import dataclasses as _dc
    cfg_t = stack_align.StackAlignConfig(
        max_displacement=128, residual=4,
        mesh=_dc.replace(stack_align.StackAlignConfig().mesh,
                         num_iters=250))

    def run_tight():
      rendered, _, ovf = stack_align.align_stack_pipelined(
          stack_j, cfg_t, out_dtype=jnp.uint8)

      def stats_one(r_u8):
        r = r_u8.astype(jnp.float32)
        base_i = stack_j[0][inter].astype(jnp.float32)
        return (jnp.sum(r[::97, ::97]),
                jnp.mean(jnp.abs(r[inter] - base_i)))

      sums, errs = jax.lax.map(stats_one, rendered[1:])
      return jnp.sum(sums), jnp.max(errs), ovf

    jax.block_until_ready(run_tight())
    ts = []
    for _ in range(3):
      t0 = time.perf_counter()
      acc_t, err_t, ovf_t = jax.block_until_ready(run_tight())
      ts.append(time.perf_counter() - t0)
    t_med = sorted(ts)[1]
    results['pipeline_tight_mpix_s'] = round(
        (n_z - 1) * n * n / t_med / 1e6, 1)
    results['pipeline_tight_max_err'] = round(float(err_t), 2)
    results['pipeline_tight_overflow'] = bool(ovf_t)

  _guard(results, 'pipeline_tight', stage_pipeline_tight)

  # ---- ESTIMATE MISSING FLOW: host-orchestrated retry stage. -------------
  _progress('stage estimate_missing_flow ...')
  # Small scale: the stage is host-loop bound; tracked for regressions
  # only.
  from sofima_tpu.processor import flow as flow_proc
  from sofima_tpu.processor.defaults import em_2d
  from sofima_tpu.utils.volume import InMemoryVolume
  from sofima_tpu.utils.bounding_box import BoundingBox
  from sofima_tpu.utils.subvolume import Subvolume
  import dataclasses as _dc

  tex_s = pre_np[:1200, :1200]
  stack = np.stack([tex_s, np.full_like(tex_s, 128.0),
                    np.roll(tex_s, 5, axis=1)])
  cfg = em_2d.estimate_missing_flow_config({
      'patch_size': 160, 'stride': 40, 'batch_size': 512,
      'max_delta_z': 2})
  cfg = _dc.replace(cfg, image_volinfo=InMemoryVolume(
      stack[None], fill_value=0.0), image_cache_bytes=1 << 28)
  proc = flow_proc.EstimateMissingFlow(cfg)
  g = 1200 // 40
  flow_in = np.full((2, 1, g, g), np.nan, np.float32)
  sv = Subvolume(flow_in.copy(), BoundingBox(start=(0, 0, 2),
                                             size=(g, g, 1)))
  proc.process(sv)  # warmup (compiles)
  # Median of 3 with spread: host-orchestrated stages vary run to run.
  t_missing_all = []
  for _ in range(3):
    t0 = time.perf_counter()
    out_missing = proc.process(Subvolume(flow_in.copy(),
                                         BoundingBox(start=(0, 0, 2),
                                                     size=(g, g, 1))))
    t_missing_all.append(time.perf_counter() - t0)
  t_missing_all.sort()
  results['estimate_missing_flow_s'] = round(t_missing_all[1], 3)
  results['estimate_missing_flow_spread_s'] = round(
      t_missing_all[-1] - t_missing_all[0], 3)
  results['estimate_missing_filled'] = int(
      np.isfinite(out_missing.data[0]).sum())

  # ---- MONTAGE 2D (BASELINE scenario 2): 3x3 tile grid, end-to-end. ------
  # The flagship 2d montage workflow (SURVEY §3.4 / em_stitching):
  # coarse whole-overlap offsets -> tile-level placement solve -> fine
  # overlap flow -> joint elastic solve -> render. Device-resident
  # chain (pipeline.montage): tiles live on the device (device_put
  # outside the timed loop, like the pipeline stage's stack), the canvas
  # never leaves the device, and the only per-run d2h is stats/meshes.
  # The host-orchestrated chain (stitch_rigid/warp.render_tiles) is
  # correctness-covered in tests.
  # Median-of-3 of the COMPLETE chain, gated on montage-vs-source error.
  def stage_montage2d():
    from sofima_tpu.pipeline import montage
    grid_t, tile_t, overlap_t = 3, 3600, 400
    step_t = tile_t - overlap_t
    n_m = step_t * (grid_t - 1) + tile_t  # 10000
    img_m = pre_np[:n_m, :n_m]
    tiles = {}
    for ty in range(grid_t):
      for tx in range(grid_t):
        tiles[(tx, ty)] = jax.device_put(
            img_m[ty * step_t:ty * step_t + tile_t,
                  tx * step_t:tx * step_t + tile_t])
    cfg_mont = montage.MontageConfig(
        stride=40, patch_size=160, coarse_overlaps=(360, 440),
        min_overlap=200, margin=16, flow_batch=256,
        mesh_cfg=mesh.IntegrationConfig(
            dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0, 40.0),
            num_iters=1000, max_iters=20000, stop_v_max=0.005,
            dt_max=100.0))

    def run_montage():
      return jax.block_until_ready(
          montage.montage_align_2d(tiles, (grid_t, grid_t), cfg_mont))

    run_montage()  # warmup (compiles)
    tms, out = [], None
    for _ in range(3):
      t0 = time.perf_counter()
      out = run_montage()
      tms.append(time.perf_counter() - t0)
    tms.sort()
    t_m = tms[1]
    solved, key_to_idx = out['solved'], out['key_to_idx']
    # Compare modulo the solver's global-translation gauge. Quality is
    # device-reduced (no canvas fetch).
    sx = int(round(solved[0, key_to_idx[(0, 0)], 0, 0]))
    sy = int(round(solved[1, key_to_idx[(0, 0)], 0, 0]))
    lo, hi = tile_t // 4, n_m - tile_t // 4
    truth_m = jax.device_put(img_m[lo:hi, lo:hi].astype(np.float32))

    @jax.jit
    def montage_quality(canvas, mask_r, truth):
      c = jax.lax.dynamic_slice(canvas, (lo + sy, lo + sx), truth.shape)
      m_ = jax.lax.dynamic_slice(mask_r, (lo + sy, lo + sx), truth.shape)
      err = jnp.sum(jnp.where(m_, jnp.abs(c - truth), 0.0))
      cnt = jnp.sum(m_)
      return err / jnp.maximum(cnt, 1), cnt / truth.size

    err_m, cov_m = montage_quality(out['canvas'], out['mask'], truth_m)
    results['montage2d_s'] = round(t_m, 3)
    results['montage2d_spread_s'] = round(tms[-1] - tms[0], 3)
    results['montage2d_mpix_s'] = round(n_m * n_m / t_m / 1e6, 1)
    results['montage2d_err'] = round(float(err_m), 3)
    results['montage2d_coverage'] = round(float(cov_m), 4)
    results['montage2d_overflow'] = bool(out['overflow'])

  _guard(results, 'montage2d', stage_montage2d)

  # ---- STITCH 3D (BASELINE scenario 4): 2x2 LICONN tile grid. ------------
  # Volumetric tile stitching end-to-end: fine 3d overlap flow (circular
  # strip kernel, strips upload h2d) -> joint 3d elastic solve
  # (26-neighbor stencil) -> distance-weighted blended render, fully
  # device-resident (pipeline.stitch3d; the host StitchAndRender3dTiles
  # twin is correctness-covered in tests/test_stitching3d.py).
  # Median-of-3 of the complete chain, gated on montage-vs-source
  # relative error, quality DEVICE-reduced.
  def stage_stitch3d():
    from sofima_tpu.pipeline import stitch3d

    zdim, tile_yx, overlap3 = 64, 576, 64
    step3t = tile_yx - overlap3  # 512
    n3 = step3t + tile_yx  # 1088
    # Band-limited 3d texture (separable-ish filtering via FFT).
    rng3 = np.random.RandomState(9)
    noise3 = rng3.rand(zdim, n3, n3).astype(np.float32)
    f3d = np.fft.rfftn(noise3)
    fz = np.fft.fftfreq(zdim)[:, None, None]
    fy3 = np.fft.fftfreq(n3)[None, :, None]
    fx3 = np.fft.rfftfreq(n3)[None, None, :]
    f3d *= np.exp(-((fx3**2 + fy3**2 + fz**2) / (2 * 0.12**2)))
    vol3 = np.fft.irfftn(f3d, s=(zdim, n3, n3)).astype(np.float32)
    vol3 = (vol3 - vol3.min()) / np.ptp(vol3) * 255.0
    del noise3, f3d

    tiles3 = {}
    for ty in range(2):
      for tx in range(2):
        tiles3[(tx, ty)] = np.ascontiguousarray(
            vol3[:, ty * step3t:ty * step3t + tile_yx,
                 tx * step3t:tx * step3t + tile_yx])
    dev_tiles3 = {k: jax.device_put(v) for k, v in tiles3.items()}
    stride3 = (16, 16, 16)
    cfg_s3 = stitch3d.Stitch3dConfig(
        stride=stride3, patch_size=(32, 32, 32), flow_batch=64, margin=8,
        mesh_cfg=mesh.IntegrationConfig(
            dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=stride3,
            num_iters=400, max_iters=10000, stop_v_max=0.005,
            dt_max=100.0))

    # Coarse offsets (xyz channels): x-pairs overlap by `overlap3` in
    # x, y-pairs in y; unused pair slots stay NaN.
    cx3 = np.full((3, 1, 2, 2), np.nan)
    cx3[0, 0, :, 0] = -overlap3
    cx3[1, 0, :, 0] = 0.0
    cx3[2, 0, :, 0] = 0.0
    cy3 = np.full((3, 1, 2, 2), np.nan)
    cy3[0, 0, 0, :] = 0.0
    cy3[1, 0, 0, :] = -overlap3
    cy3[2, 0, 0, :] = 0.0
    coarse3 = np.zeros((3, 1, 2, 2), np.float32)
    for ty in range(2):
      for tx in range(2):
        coarse3[0, 0, ty, tx] = -overlap3 * tx
        coarse3[1, 0, ty, tx] = -overlap3 * ty

    def run_stitch3d():
      return jax.block_until_ready(stitch3d.stitch_and_render_3d(
          tiles3, cx3, cy3, coarse3, cfg_s3, device_tiles=dev_tiles3))

    run_stitch3d()  # warmup (compiles)
    t3s, out3 = [], None
    for _ in range(3):
      t0 = time.perf_counter()
      out3 = run_stitch3d()
      t3s.append(time.perf_counter() - t0)
    t3s.sort()
    t_s3 = t3s[1]

    # Quality, device-reduced: the canvas reproduces the source volume
    # over the covered interior (z/y/x borders trimmed one overlap).
    lo_z, lo_yx = 8, 16
    truth3 = jax.device_put(
        vol3[lo_z:zdim - lo_z, lo_yx:n3 - lo_yx, lo_yx:n3 - lo_yx])

    @jax.jit
    def stitch3d_quality(canvas, weights, truth):
      c = canvas[lo_z:zdim - lo_z, lo_yx:n3 - lo_yx, lo_yx:n3 - lo_yx]
      w = weights[lo_z:zdim - lo_z, lo_yx:n3 - lo_yx, lo_yx:n3 - lo_yx]
      m = w > 0
      err = jnp.sum(jnp.where(m, jnp.abs(c - truth), 0.0))
      cnt = jnp.sum(m)
      return (err / jnp.maximum(cnt, 1) / jnp.std(truth),
              cnt / truth.size)

    rel3, cov3 = stitch3d_quality(out3['canvas'], out3['weights'], truth3)
    n_out_vox = zdim * n3 * n3  # the stitched union volume
    results['stitch3d_s'] = round(t_s3, 3)
    results['stitch3d_spread_s'] = round(t3s[-1] - t3s[0], 3)
    results['stitch3d_mvox_s'] = round(n_out_vox / t_s3 / 1e6, 1)
    results['stitch3d_solve_steps'] = int(out3['solve_steps'])
    results['stitch3d_rel_err'] = round(float(rel3), 4)
    results['stitch3d_coverage'] = round(float(cov3), 4)

  _guard(results, 'stitch3d', stage_stitch3d)

  # ---- MESH: relaxation throughput, XLA stencil. -------------------------
  _progress('stage mesh ...')
  cfg = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0, 40.0),
      num_iters=1000, max_iters=1000, stop_v_max=0.0, dt_max=100.0)
  xm = jax.device_put(rng.randn(2, 1, 2048, 2048).astype(np.float32))
  vm = jnp.zeros_like(xm)
  prev = jnp.zeros_like(xm)

  def run_mesh():
    return mesh.velocity_verlet(xm, vm, prev, cfg, force_cap=1e6)

  _, t_mesh, _sp = _time(run_mesh)
  glups = cfg.num_iters * 2048 * 2048 / t_mesh / 1e9
  results['mesh_glups'] = round(glups, 2)
  results['mesh_vs_gpu_baseline'] = round(glups / 2.3, 2)

  # prefer_orig_order (fold-preventing) variant.
  cfg_po = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0, 40.0),
      num_iters=1000, max_iters=1000, stop_v_max=0.0, dt_max=100.0,
      prefer_orig_order=True)

  def run_mesh_po():
    return mesh.velocity_verlet(xm, vm, prev, cfg_po, force_cap=1e6)

  _, t_mesh_po, _sp = _time(run_mesh_po)
  results['mesh_glups_prefer_orig_order'] = round(
      cfg.num_iters * 2048 * 2048 / t_mesh_po / 1e9, 2)

  # Steps per second of the fused convergence loop (relax_mesh_fused, the
  # solver of every pipeline) at fixed length, on the section mesh the
  # 10k^2 stack solves (250^2), the GLUPS mesh (2048^2) and a LICONN
  # stitch mesh (3 x 8 x 128 x 256). On small meshes the step is bound
  # by per-step launch cost, not arithmetic.
  def fused_steps_per_s(shape, stride3):
    cfg_f = mesh.IntegrationConfig(
        dt=0.001, gamma=0.0, k0=0.1, k=0.1, stride=stride3,
        num_iters=125, max_iters=2000, stop_v_max=0.0, dt_max=100.0,
        start_cap=10.0, final_cap=10.0, prefer_orig_order=True)
    xf = jax.device_put(rng.randn(*shape).astype(np.float32))
    force = mesh.inplane_force if shape[0] == 2 else mesh.elastic_mesh_3d
    _, t_f, _sp = _time(lambda: mesh.relax_mesh_fused(
        xf, jnp.zeros_like(xf), cfg_f, mesh_force=force)[0])
    return cfg_f.max_iters / t_f

  results['mesh_fused_steps_s_250'] = round(
      fused_steps_per_s((2, 1, 250, 250), (40.0, 40.0)), 1)
  results['mesh_fused_steps_s_2048'] = round(
      fused_steps_per_s((2, 1, 2048, 2048), (40.0, 40.0)), 1)
  results['mesh_fused_steps_s_3d'] = round(
      fused_steps_per_s((3, 8, 128, 256), (40.0, 40.0, 40.0)), 1)

  # ---- MESH 3D: volumetric 26-neighbor relaxation (LICONN solver). -------
  cfg3 = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0, 40.0, 40.0),
      num_iters=200, max_iters=200, stop_v_max=0.0, dt_max=100.0)
  x3 = jax.device_put(rng.randn(3, 8, 512, 1024).astype(np.float32))
  v3 = jnp.zeros_like(x3)
  prev3 = jnp.zeros_like(x3)
  n_nodes3 = 8 * 512 * 1024

  def stage_mesh3d_xla():
    def run_mesh3d_xla():
      return mesh.velocity_verlet(x3, v3, prev3, cfg3, force_cap=1e6,
                                  mesh_force=mesh.elastic_mesh_3d)

    _, t_mesh3x, _sp = _time(run_mesh3d_xla)
    results['mesh3d_glups_xla'] = round(
        cfg3.num_iters * n_nodes3 / t_mesh3x / 1e9, 2)

  _guard(results, 'mesh3d_xla', stage_mesh3d_xla)

  # Informational-by-design flags, documented in the JSON itself so the
  # record explains its own caveats.
  results['pipeline_tight_note'] = (
      'residual=4 envelope-relaxed variant: a few border tiles exceed the '
      'static envelope (overflow=true expected); informational only, '
      'never the headline')

  # ---- HARD QUALITY GATES: a regression exits nonzero (the numbers ----
  # above are still printed first so the record survives). New-stage
  # metrics default to FAILING values: a stage that errors out fails its
  # gates rather than silently disappearing from the record.
  gates = {
      'pipeline_max_err <= 3.5':
          results.get('pipeline_max_err', 99.0) <= 3.5,
      'pipeline_overflow == False':
          not results.get('pipeline_overflow', True),
      'flow_bf16_peak_agreement >= 0.999':
          results.get('flow_bf16_peak_agreement', 0.0) >= 0.999,
      'flow_masked_bf16_peak_agreement >= 0.999':
          results.get('flow_masked_bf16_peak_agreement', 0.0) >= 0.999,
      'flow3d_peak_agreement >= 0.999':
          results.get('flow3d_peak_agreement', 1.0) >= 0.999,
      'flow_masked_valid_frac >= 0.5':
          results.get('flow_masked_valid_frac', 0.0) >= 0.5,
      # Fused single-pair combined chain: ground-truth render error and
      # static-envelope integrity.
      'combined_err <= 4.0':
          results.get('combined_err', 99.0) <= 4.0,
      'combined_overflow == False':
          not results.get('combined_overflow', True),
      # BASELINE scenario 2 (2d montage) and 4 (LICONN stitching).
      'montage2d_err <= 10.0':
          results.get('montage2d_err', 99.0) <= 10.0,
      'montage2d_coverage >= 0.95':
          results.get('montage2d_coverage', 0.0) >= 0.95,
      'stitch3d_rel_err <= 0.5':
          results.get('stitch3d_rel_err', 99.0) <= 0.5,
      'stitch3d_coverage >= 0.5':
          results.get('stitch3d_coverage', 0.0) >= 0.5,
  }
  failed = sorted(name for name, ok in gates.items() if not ok)
  results['gates_failed'] = failed

  combined_headline = results.get('combined_mpix_s', mpix_s)
  dev = jax.devices()[0]
  results['device'] = {'platform': dev.platform, 'kind': dev.device_kind,
                       'count': len(jax.devices())}
  results['xla_flags'] = os.environ.get('XLA_FLAGS', '')
  out = {
      'metric': ('end-to-end pipeline Mpix/s/chip '
                 '(16x 10k^2 stack: flow+clean+solve+invert+render)'),
      'value': results['pipeline_mpix_s'],
      'unit': 'Mpix/s',
      'vs_baseline': round(results['pipeline_mpix_s'] / 1000.0, 3),
      'combined_vs_baseline': round(combined_headline / 1000.0, 3),
      **results,
  }
  print(json.dumps(out))
  if failed:
    print(f'BENCH QUALITY GATES FAILED: {failed}', file=sys.stderr)
    return 1
  return 0


if __name__ == '__main__':
  sys.exit(main())
