"""Device-resident serial-section stack alignment.

The reference's production chain (SURVEY.md §3.3; em_alignment notebook,
/root/reference/processor layers) runs flow -> clean -> solve -> invert
-> render as separate stages with materialized volumes between them.
Here the whole per-section chain compiles into ONE jit program:

  1. FLOW    coarse-to-fine dense grid (flow_field.coarse_to_fine_flow)
  2. CLEAN   clean_flow_device quality gates
  3. SOLVE   relax_mesh_fused, warm-started from the spring targets
  4. INVERT  fixed-point map inversion + harmonic hole fill
  5. RENDER  Lanczos gather resampling (ops.interp.sample) through the
             densified inverse map; a device-computed tiled plan
             (shift_warp.tiled_plan_device) checks the static
             displacement envelope

There is NO host synchronization anywhere in the chain: section z's
solve feeds section z+1's compose as a device array, plans are computed
on device, and the only d2h is whatever checksum or statistic the
caller fetches at the end.

Static shape contract: all sections share one (square) shape and one
patch/stride geometry, so the per-section program compiles once.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from sofima_tpu import flow_field
from sofima_tpu import flow_utils
from sofima_tpu import map_utils
from sofima_tpu import mesh
from sofima_tpu.ops import fill as fill_ops
from sofima_tpu.ops import interp as interp_ops
from sofima_tpu.ops import shift_warp


@dataclasses.dataclass(frozen=True)
class StackAlignConfig:
  """Static configuration of the fused per-section pipeline step."""
  patch: int = 160
  stride: int = 40
  coarse_to_fine: bool = True
  # Fine-pass patch edge for coarse_to_fine (None = patch // 2). Smaller
  # is faster (the correlation is O(edge^3) per patch) at some
  # statistical robustness cost; capture range is set by the coarse
  # prior, not this.
  fine_patch: int | None = None
  # Coarse-pass grid step for coarse_to_fine (None = patch, i.e. a
  # full-patch-sized step). Larger steps shrink the coarse correlation
  # cost proportionally; the prior only needs to resolve deformation
  # wavelengths, not pixels.
  coarse_step: int | None = None
  # Fine-pass peak-search crop (even px, None = full surface). The
  # coarse prior bounds the fine residual to a few px, so searching the
  # full fine_patch^2 correlation surface wastes most of the peak
  # chain's work (flow_field.targeted_flow_peaks).
  # Size >= 4x `residual`; gated by the bench ground-truth bound.
  peak_crop: int | None = None
  # Warm-start flow priors (pipelined driver only): section pair z
  # targets its fine flow pass from pair z-1's cleaned flow instead of
  # running a coarse pass (temporal coherence of serial sections). The
  # first pair always runs the full coarse-to-fine chain. The fine pass
  # re-measures peaks exactly, so a stale prior costs capture margin —
  # the per-pair flow must stay within the fine surface (or `peak_crop`
  # core) of the previous pair's; size peak_crop/fine_patch for the
  # expected section-to-section drift. Gated by the bench ground-truth
  # bound like every other lever.
  warm_start: bool = False
  # Stale-prior refresh (warm_start only). A warm pair is re-measured
  # with a full coarse pass (lax.cond: the refresh branch costs nothing
  # unless taken) when any of three staleness signals fire:
  #   * the fine pass overflowed its targeting clamp;
  #   * fewer than `warm_refresh_min_valid` of the interior nodes
  #     survive clean_flow (a stale prior shifts the fine windows off
  #     target and the mis-measured peaks fail the ratio/sharpness/
  #     deviation gates);
  #   * >5% of surviving nodes measure a fine residual (|flow - prior|)
  #     beyond 3/4 of the fine surface's capture half-range — the
  #     signature of residual ALIASING: the fine correlation is
  #     circular, so a prior stale by more than the capture range can
  #     produce smooth, confident, wrong-by-one-period peaks that the
  #     clean gates cannot see. Healthy warm residuals are the
  #     section-to-section flow delta (a few px), far inside the bound.
  # None disables the refresh and keeps the flag-only behavior.
  warm_refresh_min_valid: float | None = 0.5
  bf16: bool = True
  # clean_flow gates (EM-2D defaults, processor/defaults/em_2d.py).
  min_peak_ratio: float = 1.6
  min_peak_sharpness: float = 1.6
  max_magnitude: float = 80.0
  max_deviation: float = 20.0
  # Static displacement envelopes (see flow_field.coarse_to_fine_flow):
  # |flow| is clipped to max_displacement, and `residual` bounds the
  # per-tile variation of the inverse map around its integer base. The
  # render itself samples exactly; the `overflow` output flags a map
  # outside either envelope.
  max_displacement: int = 96
  residual: int = 8
  method: str = 'lanczos'
  # Newton refinement iterations for the map inversion (folds cannot
  # occur in a freshly-relaxed smooth mesh, so a couple suffice).
  invert_newton_iters: int = 2
  # Damped fixed-point iterations for the map inversion. The iteration
  # contracts the residual by ~0.4x per step on mesh-smooth maps
  # (p <- p + 0.6 (q - F(p)) with |grad d| << 1), so ~12 steps reduce a
  # 50 px initial displacement far below the 0.01*stride tolerance; the
  # library default (map_utils._invert_section num_iters=32) is sized
  # for arbitrary user maps. Failures are Newton-re-seeded and NaN ->
  # harmonic-filled either way, and the bench ground-truth gate pins
  # the quality.
  # ENVELOPE NOTE: 12/2 were tuned on smooth bench-like meshes. The
  # fixed-point contraction degrades toward 1 near strong compressions
  # (|grad d| -> 1), so dirtier-than-bench data pushes more nodes
  # through the 2-step Newton rescue into harmonic fill; pipelines on
  # such data should restore the library 32/8 values via config. The
  # quality gate covering this is the bench ground-truth bound, not a
  # unit test on extreme meshes.
  invert_fp_iters: int = 12
  # Solver protocol: start_cap = final_cap = 10 (no ramp; archival
  # em_2d ramps 0.01 -> 10 at 1.1x per converged chunk). The cap
  # escalation exists so the k0 force clamp releases gradually on
  # dirty flows; here the targets are already clean_flow-gated and the
  # solve warm-starts ON the targets, so |x - prev| at the solution is
  # << cap/k0 = 100 px — the clamp never binds and every escalation
  # chunk is a semantic no-op that still costs a full convergence
  # check. k0=0.1 (archival: 0.01) weights the flow targets 10x
  # harder against elastic smoothness — the warm start begins ON the
  # targets, so the stiffer k0 is what lets one num_iters budget
  # settle; all protocol deltas are documented in docs/PARITY.md and
  # pinned by tests/test_stack_align.py::TestFusedVsStaged.
  # Fold safety is retained (prefer_orig_order + cap 10).
  mesh: mesh.IntegrationConfig = dataclasses.field(
      default_factory=lambda: mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.1, k=0.1, stride=(40.0, 40.0),
          num_iters=500, max_iters=8000, stop_v_max=0.005,
          dt_max=100.0, start_cap=10.0, final_cap=10.0, cap_scale=1.1,
          prefer_orig_order=True))


def archival_em2d_config(**overrides) -> StackAlignConfig:
  """StackAlignConfig preset matching the reference's ARCHIVAL EM-2D
  solver protocol (/root/reference/processor/defaults/em_2d.py:137-167):
  k0=0.01 (vs the headline's 0.1), force-cap escalation 0.01 -> 10 at
  1.1x per converged chunk (vs no ramp), num_iters 1000 / max_iters 1e5.
  The flow/clean/invert/render phases are the same as the headline
  config — their integer peaks match the padfield oracle
  exactly (bench peak-agreement gates), so the protocol delta is
  confined to the solver. Use this when outputs must track the
  reference's production fixed point; the headline config reaches a
  deliberately stiffer fixed point in fewer steps (docs/PARITY.md
  "Fused-vs-staged pipeline protocol").
  """
  cfg = StackAlignConfig(
      mesh=mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0, 40.0),
          num_iters=1000, max_iters=100000, stop_v_max=0.005,
          dt_max=100.0, start_cap=0.01, final_cap=10.0, cap_scale=1.1,
          prefer_orig_order=True))
  return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _flow_phase(sec_prev, sec_cur, cfg: StackAlignConfig, grid_n: int,
                prior=None):
  """FLOW + CLEAN for one section pair -> ([2, 1, G, G], overflow).

  `prior` ([2, G, G] on the padded full grid, NaN border included)
  warm-starts the fine pass in place of the coarse one — the full-grid
  index j sits at pixel j*stride whenever stride divides patch//2
  (pad * stride == patch // 2), which the grid contract guarantees
  for the supported patch/stride geometries."""
  p, s = cfg.patch, cfg.stride
  pre = sec_prev.astype(jnp.float32)
  post = sec_cur.astype(jnp.float32)

  overflow = jnp.bool_(False)
  if cfg.coarse_to_fine:
    fp = None if cfg.fine_patch is None else (cfg.fine_patch,
                                              cfg.fine_patch)
    cs = None if cfg.coarse_step is None else (cfg.coarse_step,
                                               cfg.coarse_step)
    f4, overflow = flow_field.coarse_to_fine_flow(
        pre, post, (p, p), (s, s), coarse_step=cs, fine_patch=fp,
        bf16=cfg.bf16, max_displacement=cfg.max_displacement,
        residual=cfg.residual, return_overflow=True,
        peak_crop=cfg.peak_crop, prior=prior,
        prior_step=None if prior is None else (s, s),
        prior_origin=None if prior is None else
        (p // 2 - (p // 2 // s) * s, p // 2 - (p // 2 // s) * s))
  else:
    f4 = flow_field.dense_flow_field(
        pre, post, (p, p), (s, s), batch_size=256, circular=True,
        dft_matmul=True, bf16=cfg.bf16)

  clean = flow_utils.clean_flow_device(
      f4[:, None], cfg.min_peak_ratio, cfg.min_peak_sharpness,
      cfg.max_magnitude, cfg.max_deviation)

  pad = p // 2 // s
  full = jnp.full((2, 1, grid_n, grid_n), jnp.nan, jnp.float32)
  full = jax.lax.dynamic_update_slice(full, clean, (0, 0, pad, pad))
  return full, overflow


def _solve_phase(flow_full, solved_prev, cfg: StackAlignConfig):
  """SOLVE one section: spring targets from the composed flow, fused
  FIRE relaxation warm-started from the targets themselves (the k0
  springs then begin satisfied and FIRE only relaxes elastic
  smoothness); cf. the reference's compute_ref_mesh
  (/root/reference/processor/mesh.py:248-277)."""
  s = cfg.stride
  grid_n = flow_full.shape[-1]
  zero3 = np.zeros(3, np.float32)
  prev = map_utils.compose_maps_fast(flow_full, zero3, float(s),
                                     solved_prev, zero3, float(s))
  x0 = jnp.where(jnp.isnan(prev), solved_prev, prev)
  solved, _, _ = mesh.relax_mesh_fused(x0, prev, cfg.mesh)
  return solved


def _invert_phase(solved, cfg: StackAlignConfig):
  """INVERT one solved mesh -> (rel_inv [2, G, G], inv_abs [2, G, G])."""
  s = cfg.stride
  grid_n = solved.shape[-1]
  node = jnp.arange(grid_n, dtype=jnp.float32) * s
  qx = jnp.broadcast_to(node[None, :], (grid_n, grid_n))
  qy = jnp.broadcast_to(node[:, None], (grid_n, grid_n))
  query = jnp.stack([qx, qy])  # xy channels, physical pixels
  abs_map = solved[:, 0] + query
  zeros2 = jnp.zeros(2, jnp.float32)
  stride2 = jnp.full((2,), float(s), jnp.float32)
  inv_abs = map_utils._invert_section(
      abs_map, zeros2, query, stride2,
      num_iters=cfg.invert_fp_iters,
      newton_iters=cfg.invert_newton_iters,
      shift_bound=-(-cfg.max_displacement // s) + 1)
  rel_inv = inv_abs - query
  valid = jnp.isfinite(rel_inv[0]) & jnp.isfinite(rel_inv[1])
  rel_inv = fill_ops.fill_invalid(rel_inv, valid, extrapolate=True)
  inv_abs = rel_inv + query
  return rel_inv, inv_abs


def _render_phase(sec_cur, rel_inv, inv_abs, cfg: StackAlignConfig):
  """RENDER one section through its inverted map -> (image, overflow)."""
  s = cfg.stride
  n = sec_cur.shape[-1]
  grid_n = rel_inv.shape[-1]
  node_np = np.arange(grid_n, dtype=np.float64) * s
  md = -(-cfg.max_displacement // 64) * 64
  env_r = (-cfg.residual, cfg.residual, -cfg.residual, cfg.residual)
  env_b = (-md, md, -md, md)
  dplan = shift_warp.tiled_plan_device(
      rel_inv[1][None], rel_inv[0][None], node_np, node_np, (n, n),
      env_r, env_b)
  dense = interp_ops.upsample_map_linear(
      jnp.stack([inv_abs[1], inv_abs[0]]), s, (0, 0), (n, n))
  rendered = interp_ops.sample(sec_cur, dense, method=cfg.method,
                               mode='constant', cval=0.0)
  return rendered, dplan['overflow']


@functools.partial(jax.jit, static_argnames=['cfg'])
def align_step(sec_prev: jnp.ndarray, sec_cur: jnp.ndarray,
               solved_prev: jnp.ndarray, cfg: StackAlignConfig):
  """One fused pipeline step: returns (solved, rendered, overflow).

  Args:
    sec_prev/sec_cur: [n, n] raw adjacent sections (uint8 or float)
    solved_prev: [2, 1, G, G] relative mesh of the previous section
      (zeros for the first moving section); G = n // stride
    cfg: static configuration

  Returns:
    solved: [2, 1, G, G] relative mesh for sec_cur
    rendered: [n, n] float32 sec_cur rendered into the aligned frame
    overflow: bool scalar — a static envelope was exceeded somewhere
      (flow targeting or render displacement; affected pixels render
      as zeros / from clipped targets)
  """
  grid_n = sec_cur.shape[-1] // cfg.stride
  flow_full, ov_flow = _flow_phase(sec_prev, sec_cur, cfg, grid_n)
  solved = _solve_phase(flow_full, solved_prev, cfg)
  rel_inv, inv_abs = _invert_phase(solved, cfg)
  rendered, ov_render = _render_phase(sec_cur, rel_inv, inv_abs, cfg)
  return solved, rendered, jnp.logical_or(ov_flow, ov_render)


@functools.partial(jax.jit, static_argnames=['cfg', 'out_dtype'])
def align_stack_pipelined(stack: jnp.ndarray,
                          cfg: StackAlignConfig = StackAlignConfig(),
                          out_dtype=None):
  """Whole-stack alignment as ONE jit program with batched phases.

  The per-section chain (`align_step`) is more sequential than its own
  dependency graph: only the mesh solve carries the z -> z+1 dependency
  (a tiny [2, 1, G, G] state), while flow/clean and invert/render are
  z-independent. This driver restructures the stack into four phases:

    1. FLOW+CLEAN   all Z-1 section pairs, a lax.map over pairs;
    2. SOLVE        a lax.scan of the fused FIRE solve over z — the
                    only truly sequential work, on G^2-node state;
    3. INVERT+FILL  vmap over z: the small-grid algebra (fixed point +
                    Newton + harmonic fill) is op-dispatch-latency
                    bound per section, so batching all sections into
                    each op amortizes it Z-fold;
    4. RENDER       lax.map of the Lanczos gather render.

  Returns (rendered [Z, n, n], solved [Z, 2, 1, G, G], overflow), with
  rendered[0] = stack[0] and solved[0] = 0 (the anchor section).
  `out_dtype=jnp.uint8` halves HBM for large stacks (values are
  clip-rounded); None keeps float32.
  """
  z_dim, n, _ = stack.shape
  grid_n = n // cfg.stride
  solved0 = jnp.zeros((2, 1, grid_n, grid_n), jnp.float32)

  # Phase 1: flow + clean for every adjacent pair. Without warm_start
  # the pairs are z-independent (lax.map); with it, pair z targets its
  # fine pass from pair z-1's cleaned flow (lax.scan, no coarse pass
  # after the first pair) — same dispatch count per pair minus the
  # coarse pass, and lax.map executes sequentially anyway.
  def flow_one(z, prior=None):
    pre = jax.lax.dynamic_index_in_dim(stack, z, keepdims=False)
    post = jax.lax.dynamic_index_in_dim(stack, z + 1, keepdims=False)
    return _flow_phase(pre, post, cfg, grid_n, prior=prior)

  if cfg.warm_start and cfg.coarse_to_fine and z_dim > 2:
    flow0, ov0 = flow_one(jnp.int32(0))
    pad = cfg.patch // 2 // cfg.stride

    fp = cfg.fine_patch if cfg.fine_patch is not None else cfg.patch // 2
    # Capture half-range of the fine peak search: the peak_crop core
    # when set, else a conservative quarter of the (circular) fine
    # window — peaks near the window edge are wrap-suspect even when
    # they are inside the nominal +-fp/2 unique range.
    cap_half = (cfg.peak_crop // 2 if cfg.peak_crop is not None
                else fp // 4)

    def flow_scan(prev_flow, z):
      fl, ov = flow_one(z, prior=prev_flow[:, 0])
      if cfg.warm_refresh_min_valid is not None:
        # Stale-prior refresh (see StackAlignConfig.warm_refresh_min_
        # valid): lost peaks, targeting overflow, or near-capture
        # residuals trigger a re-measure from a fresh coarse pass. The
        # cond branch reuses the first pair's compiled coarse kernels
        # and costs nothing at runtime unless taken.
        sl = lambda a: jax.lax.slice(
            a, (0, 0, pad, pad),
            (a.shape[0], 1, a.shape[2] - pad, a.shape[3] - pad))
        interior = sl(fl)
        finite = jnp.isfinite(interior[0, 0])
        valid = jnp.mean(finite)
        resid = jnp.abs(interior - sl(prev_flow))
        resid = jnp.nan_to_num(jnp.max(resid, axis=(0, 1)))
        saturated = jnp.sum(finite & (resid > 0.75 * cap_half))
        frac_sat = saturated / jnp.maximum(jnp.sum(finite), 1)
        stale = (ov | (valid < cfg.warm_refresh_min_valid)
                 | (frac_sat > 0.05))
        fl, ov = jax.lax.cond(stale, lambda: flow_one(z),
                              lambda: (fl, ov))
      return fl, (fl, ov)

    _, (flows_rest, ov_rest) = jax.lax.scan(
        flow_scan, flow0, jnp.arange(1, z_dim - 1))
    flows = jnp.concatenate([flow0[None], flows_rest], axis=0)
    ov_flow = jnp.concatenate([ov0[None], ov_rest], axis=0)
  else:
    flows, ov_flow = jax.lax.map(flow_one, jnp.arange(z_dim - 1))

  # Phase 2: the sequential solve chain (tiny state, fused solve).
  def solve_one(solved_prev, flow_full):
    solved = _solve_phase(flow_full, solved_prev, cfg)
    return solved, solved

  _, solved_seq = jax.lax.scan(solve_one, solved0, flows)

  # Phase 3: invert + fill, batched over z.
  rel_inv_all, inv_abs_all = jax.vmap(
      lambda sv: _invert_phase(sv, cfg))(solved_seq)

  # Phase 4: render each section (lax.map
  # keeps the dense per-section coords transient).
  def render_one(args):
    z1, rel_inv, inv_abs = args
    sec = jax.lax.dynamic_index_in_dim(stack, z1, keepdims=False)
    rendered, ov = _render_phase(sec, rel_inv, inv_abs, cfg)
    if out_dtype is not None and rendered.dtype != jnp.dtype(out_dtype):
      rendered = jnp.clip(jnp.rint(rendered), 0, 255).astype(out_dtype)
    return rendered, ov

  rendered_seq, ov_render = jax.lax.map(
      render_one, (jnp.arange(1, z_dim), rel_inv_all, inv_abs_all))

  first = stack[0]
  if out_dtype is None:
    first = first.astype(jnp.float32)
  else:
    first = jnp.clip(jnp.rint(first.astype(jnp.float32)),
                     0, 255).astype(out_dtype)
  rendered = jnp.concatenate([first[None], rendered_seq], axis=0)
  solved = jnp.concatenate([solved0[None], solved_seq], axis=0)
  overflow = jnp.any(ov_flow) | jnp.any(ov_render)
  return rendered, solved, overflow


def align_stack(stack, cfg: StackAlignConfig = StackAlignConfig(),
                pipelined: bool = True, out_dtype=None):
  """Aligns a [Z, n, n] stack; returns (rendered [Z, n, n], solved,
  overflow).

  `pipelined=True` runs the whole stack as one batched-phase program
  (`align_stack_pipelined`); `pipelined=False` streams section by
  section through `align_step` — a host loop that only enqueues device
  work (the solved mesh flows z -> z+1 as a device array), useful when
  sections arrive incrementally or the stack exceeds HBM.
  """
  stack = jnp.asarray(stack)
  if pipelined:
    return align_stack_pipelined(stack, cfg, out_dtype)
  z_dim, n, _ = stack.shape
  grid_n = n // cfg.stride
  solved = jnp.zeros((2, 1, grid_n, grid_n), jnp.float32)
  rendered = [stack[0].astype(jnp.float32)]
  solved_all = [solved]
  overflow = jnp.bool_(False)
  for z in range(1, z_dim):
    solved, r, ov = align_step(stack[z - 1], stack[z], solved, cfg)
    rendered.append(r)
    solved_all.append(solved)
    overflow = jnp.logical_or(overflow, ov)
  return jnp.stack(rendered), jnp.stack(solved_all), overflow
