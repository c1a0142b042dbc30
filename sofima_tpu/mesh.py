"""Elastic spring-mesh relaxation (velocity Verlet + FIRE), on device.

Provides the capability of the reference mesh solver
(/root/reference/mesh.py): minimize the energy of a rectangular grid of
Hookean springs (nearest + next-nearest neighbors; 13 link directions in
3d) with damped velocity Verlet integration, optionally accelerated by the
FIRE scheme (Bitzer et al., PRL 97, 170201), with inter-section zero-length
springs against a reference ('prev') mesh, force capping with adaptive
upscaling, fold-prevention force reformulation, and drift removal.

Positions are relative: node (i, j) with value (Δx, Δy) sits at
(i·stride + Δx, j·stride + Δy).

Design:
  * One generic stencil (`_spring_force`) expresses every spring family as
    a shifted-difference + scatter pair, instead of per-family unrolled
    code; XLA fuses the whole force evaluation into a handful of
    kernels with no device-memory round trips between families.
  * `relax_mesh` keeps the reference's host-side convergence loop and
    telemetry; `relax_mesh_fused` moves the *entire* convergence loop into
    a single `lax.while_loop` device program (no host syncs until
    convergence) — the high-performance path used by the processors and
    benchmarks.
  * The same step function powers the multi-chip spatially-sharded solver
    in `sofima_tpu.parallel.mesh_sharding` (halo exchange between
    devices).
"""

from __future__ import annotations

import collections.abc
import dataclasses
import functools
import logging
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

# 13 link directions (xyz components) covering the 26-neighborhood of a
# node modulo inversion: 3 nearest, 6 next-nearest, 4 corner links.
MESH_LINK_DIRECTIONS: tuple[tuple[int, int, int], ...] = tuple(
    (dx, dy, dz)
    for dz in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
    if (dz, dy, dx) > (0, 0, 0)  # one representative per ± pair
)
assert len(MESH_LINK_DIRECTIONS) == 13

# In-plane link directions (xy components): — | \ / spring families.
INPLANE_LINK_DIRECTIONS: tuple[tuple[int, int], ...] = (
    (1, 0), (0, 1), (1, 1), (-1, 1))


def _link_slices(direction_zyx: Sequence[int], ndim: int, spatial: int):
  """Slices/pads realizing a shifted-difference stencil over trailing axes.

  For a link from node i to node i+e: `hi` selects nodes i+e, `lo` selects
  nodes i, `pad_hi`/`pad_lo` scatter a quantity defined on the overlap
  back onto the i+e / i positions.
  """
  hi = [np.s_[:]] * ndim
  lo = [np.s_[:]] * ndim
  pad_hi = [(0, 0)] * ndim
  pad_lo = [(0, 0)] * ndim
  for k, e in enumerate(direction_zyx):
    axis = ndim - spatial + k
    if e == 1:
      hi[axis] = np.s_[1:]
      lo[axis] = np.s_[:-1]
      pad_hi[axis] = (1, 0)
      pad_lo[axis] = (0, 1)
    elif e == -1:
      hi[axis] = np.s_[:-1]
      lo[axis] = np.s_[1:]
      pad_hi[axis] = (0, 1)
      pad_lo[axis] = (1, 0)
    elif e != 0:
      raise ValueError('Link components must be in {-1, 0, 1}.')
  return tuple(hi), tuple(lo), pad_hi, pad_lo


def _spring_force(
    x: jnp.ndarray,
    links: Sequence[Sequence[int]],
    k_eff: Sequence[float],
    stride_xyz: Sequence[float],
    prefer_orig_order: bool,
    spatial: int,
) -> jnp.ndarray:
  """Total Hookean force from a set of spring families.

  Args:
    x: [dim, ..., (z,) y, x] relative node positions; trailing `spatial`
      axes are the grid, leading axis the xy[z] components, middle axes
      are batch
    links: link directions, xy[z] component order
    k_eff: per-link effective spring constant
    stride_xyz: grid spacing per component (xy[z] order)
    prefer_orig_order: use the fold-preventing force formulation (single
      energy minimum at the original node ordering; sacrifices rotation
      invariance)
    spatial: number of trailing grid axes

  Returns:
    force array, same shape as x
  """
  dim = x.shape[0]
  total = jnp.zeros_like(x)
  for direction, k in zip(links, k_eff):
    l0_vec = np.array(
        [stride_xyz[c] * direction[c] for c in range(dim)],
        dtype=np.float32).reshape((dim,) + (1,) * (x.ndim - 1))
    l0 = float(np.linalg.norm(l0_vec))
    hi, lo, pad_hi, pad_lo = _link_slices(direction[::-1], x.ndim, spatial)
    dx = x[hi] - x[lo] + l0_vec
    l = jnp.linalg.norm(dx, axis=0)
    if prefer_orig_order:
      # Replace the scalar rest length by a per-component signed factor so
      # the original node ordering is the unique energy minimum.
      factor = jnp.stack([
          direction[c] * jnp.sign(dx[c]) if direction[c] != 0
          else jnp.ones_like(dx[c])
          for c in range(dim)
      ])
      f = -k * (1.0 - l0 * factor / l) * dx
    else:
      f = -k * (1.0 - l0 / l) * dx
    f = jnp.nan_to_num(f, posinf=0.0, neginf=0.0)
    total = total + jnp.pad(f, pad_hi) - jnp.pad(f, pad_lo)
  return total


def inplane_force(x: jnp.ndarray, k: float, stride: Sequence[float],
                  prefer_orig_order: bool = False) -> jnp.ndarray:
  """In-plane forces of a 2d spring mesh ([2, z, y, x] positions).

  Spring families: — | (constant k) and \\ / diagonals (k/√2, keeping the
  elastic modulus constant since E ~ k·l0). `stride` is XY.
  """
  if len(stride) != 2:
    raise ValueError('stride must be 2D (XY).')
  k_diag = k / np.sqrt(2.0)
  k_eff = (k, k, k_diag, k_diag)
  return _spring_force(x, INPLANE_LINK_DIRECTIONS, k_eff, tuple(stride),
                       prefer_orig_order, spatial=2)


def elastic_mesh_3d(x: jnp.ndarray, k: float,
                    stride: float | Sequence[float],
                    prefer_orig_order: bool = False,
                    links=MESH_LINK_DIRECTIONS) -> jnp.ndarray:
  """Internal forces of a 3d spring mesh ([3, ..., z, y, x] positions).

  Per-link k_eff = k · stride_x / l0 maintains constant elasticity across
  link families. Supports extra batch axes between channels and the grid.
  """
  assert x.shape[0] == 3
  if not isinstance(stride, collections.abc.Sequence):
    stride = (float(stride),) * 3
  stride = tuple(float(s) for s in stride)
  k_eff = []
  for d in links:
    l0 = float(np.linalg.norm([stride[c] * d[c] for c in range(3)]))
    k_eff.append(k * stride[0] / l0)
  return _spring_force(x, links, k_eff, stride, prefer_orig_order, spatial=3)


@dataclasses.dataclass(frozen=True)
class IntegrationConfig:
  """Parameters for the numerical integration of the mesh state.

  Field-compatible with the reference config
  (/root/reference/mesh.py:282-338); hashable so it can be a jit static
  argument.
  """

  dt: float                # time step
  gamma: float             # damping constant
  k0: float                # inter-section (zero-length) spring constant
  k: float                 # intra-section spring constant
  stride: tuple[float, ...]  # grid spacing (XY[Z])
  num_iters: int           # steps per device dispatch
  max_iters: int           # upper bound on total steps
  stop_v_max: float        # terminate when all |v| < this (and cap final)

  fire: bool = True        # use the FIRE integrator
  # FIRE parameters.
  f_alpha: float = 0.99
  f_inc: float = 1.1
  f_dec: float = 0.5
  alpha: float = 0.1
  n_min: int = 5
  dt_max: float = 10.0     # max dt, in units of `dt`

  # Inter-section force-component magnitude cap, with adaptive upscaling
  # (start != final requires FIRE).
  start_cap: float = 1e6
  final_cap: float = 1e6
  cap_scale: float = 1.1
  cap_upscale_every: int = 100

  prefer_orig_order: bool = False
  remove_drift: bool = False

  def __post_init__(self):
    object.__setattr__(self, 'stride', tuple(self.stride))

  def to_json(self) -> str:
    from sofima_tpu.utils import config_utils
    return config_utils.to_json(self)

  @classmethod
  def from_json(cls, text: str) -> 'IntegrationConfig':
    from sofima_tpu.utils import config_utils
    return config_utils.from_json(cls, text)


def _make_step_fns(config: IntegrationConfig, mesh_force, prev_fn,
                   reduce_fn=None, mean_fn=None):
  """Builds the (damped) velocity-Verlet and FIRE step functions.

  `reduce_fn(x)`/`mean_fn(x, axes)` hooks let the sharded solver replace
  the global reductions (FIRE power, drift removal) with psum/pmean over
  the device mesh; identity for the single-chip solver.
  """
  if reduce_fn is None:
    reduce_fn = lambda v: v
  if mean_fn is None:
    # NaN-aware: absent (NaN) nodes must not poison the drift mean.
    mean_fn = lambda v, axes: jnp.nanmean(v, axis=axes, keepdims=True)

  def force(x, prev, cap):
    a = mesh_force(x, config.k, config.stride, config.prefer_orig_order)
    if prev_fn is not None:
      prev = prev_fn(x)
    if prev is not None:
      a = a + jnp.clip(-config.k0 * jnp.nan_to_num(x - prev), -cap, cap)
    return a

  def vv_step(state, dt, cap, prev):
    x, v, a = state
    x = x + dt * v + (0.5 * dt * dt) * a
    a_new = force(x, prev, cap)
    damp_in = 1.0 / (1.0 + 0.5 * dt * config.gamma)
    damp_out = 1.0 - 0.5 * dt * config.gamma
    v = damp_in * (v * damp_out + 0.5 * dt * (a + a_new))
    return x, v, a_new

  def fire_step(state, prev):
    x, v, a, dt, alpha, n_pos, cap = state
    x, v, a = vv_step((x, v, a), dt, cap, prev)

    a_norm = jnp.linalg.norm(a, axis=0, keepdims=True) + 1e-6
    v_norm = jnp.linalg.norm(v, axis=0, keepdims=True)
    power = reduce_fn(jnp.sum(a * v))
    v = v + alpha * (a / a_norm * v_norm - v)

    uphill = power < 0
    n_pos = jnp.where(uphill, 0, n_pos + 1)
    grow = (~uphill) & (n_pos > config.n_min)
    dt = jnp.where(
        uphill, dt * config.f_dec,
        jnp.where(grow, jnp.minimum(dt * config.f_inc,
                                    config.dt_max * config.dt), dt))
    alpha = jnp.where(uphill, config.alpha,
                      jnp.where(grow, alpha * config.f_alpha, alpha))
    cap = jnp.minimum(
        jnp.where((~uphill) & (n_pos > 0)
                  & (n_pos % config.cap_upscale_every == 0),
                  config.cap_scale * cap, cap),
        config.final_cap)
    v = v * (~uphill)

    if config.remove_drift:
      axes = tuple(range(1, x.ndim))
      # Node presence comes from x: absent/auto-padded nodes carry NaN
      # positions but finite (zero) velocities, so the velocity mean
      # must be masked by isfinite(x) — and absent nodes pinned at
      # v = 0 — or the padded divisor/accumulating -mean velocities
      # diverge the sharded trajectory from the single-device one.
      present = jnp.isfinite(x)
      x = x - mean_fn(x, axes)
      v = jnp.where(present,
                    v - mean_fn(jnp.where(present, v, jnp.nan), axes),
                    0.0)

    return x, v, a, dt, alpha, n_pos, cap

  return force, vv_step, fire_step


@functools.partial(jax.jit, static_argnames=['config', 'mesh_force',
                                             'prev_fn'])
def velocity_verlet(
    x: jnp.ndarray,
    v: jnp.ndarray,
    prev: jnp.ndarray | None,
    config: IntegrationConfig,
    force_cap: float,
    fire_dt: float | None = None,
    fire_alpha: float | None = None,
    mesh_force=inplane_force,
    prev_fn=None,
):
  """Runs `config.num_iters` integration steps as one device program.

  Returns (x, v, a) for plain damped Verlet, or
  (x, v, a, dt, alpha, n_pos, cap) when FIRE is enabled.
  """
  force, vv_step, fire_step = _make_step_fns(config, mesh_force, prev_fn)
  a = force(x, prev, force_cap)

  if config.fire:
    if fire_alpha is None:
      fire_alpha = config.alpha
    if fire_dt is None:
      fire_dt = config.dt
    init = (x, v, a, jnp.float32(fire_dt), jnp.float32(fire_alpha), 0,
            jnp.float32(force_cap))
    return jax.lax.fori_loop(
        0, config.num_iters, lambda t, s: fire_step(s, prev), init)
  return jax.lax.fori_loop(
      0, config.num_iters,
      lambda t, s: vv_step(s, config.dt, force_cap, prev), (x, v, a))


def relax_mesh(
    x: jnp.ndarray,
    prev: jnp.ndarray | None,
    config: IntegrationConfig,
    mesh_force=inplane_force,
    prev_fn=None,
) -> tuple[jnp.ndarray, list[float], int]:
  """Relaxes the mesh until convergence (host-driven chunked loop).

  Returns (final positions, kinetic-energy history, steps executed).
  """
  if config.start_cap != config.final_cap:
    if not config.fire:
      raise NotImplementedError(
          'Adaptive force capping requires the FIRE integrator.')
    if config.cap_scale <= 1:
      raise ValueError('cap_scale must be > 1 for adaptive capping.')
  if prev is not None and prev_fn is not None:
    raise ValueError('Only one of "prev" and "prev_fn" may be given.')

  t = 0
  v = jnp.zeros_like(x)
  dt = config.dt
  alpha = config.alpha
  cap = config.start_cap
  e_kin: list[float] = []

  while t < config.max_iters:
    state = velocity_verlet(x, v, prev, config, force_cap=cap, fire_dt=dt,
                            fire_alpha=alpha, mesh_force=mesh_force,
                            prev_fn=prev_fn)
    t += config.num_iters
    x, v = state[:2]
    v_mag = jnp.linalg.norm(v, axis=0)
    e_kin.append(float(jnp.sum(v_mag**2)))
    v_max = float(jnp.max(v_mag))

    if config.fire:
      dt, alpha, n_pos, cap = state[-4:]
      dt, alpha, cap = float(dt), float(alpha), float(cap)
      logging.info(
          't=%r: dt=%f alpha=%f n_pos=%d cap=%f v_max=%f e_kin=%f', t, dt,
          alpha, int(n_pos), cap, v_max, e_kin[-1])

    if v_max < config.stop_v_max:
      if cap >= config.final_cap:
        break
      cap = min(cap * config.cap_scale, config.final_cap)

  return x, e_kin, t


@functools.partial(jax.jit, static_argnames=['config', 'mesh_force',
                                             'prev_fn'])
def relax_mesh_fused(
    x: jnp.ndarray,
    prev: jnp.ndarray | None,
    config: IntegrationConfig,
    mesh_force=inplane_force,
    prev_fn=None,
):
  """Fully on-device mesh relaxation: ONE program until convergence.

  The convergence check (v_max < stop_v_max AND cap at final) runs inside
  a `lax.while_loop` wrapping `num_iters`-step FIRE chunks, eliminating
  every host synchronization of the chunked loop. Returns
  (x, e_kin_history [max_chunks], chunks_executed·num_iters).
  """
  if not config.fire:
    raise NotImplementedError('relax_mesh_fused requires FIRE.')

  force, _, fire_step = _make_step_fns(config, mesh_force, prev_fn)

  max_chunks = int(np.ceil(config.max_iters / config.num_iters))
  e_kin0 = jnp.full((max_chunks,), jnp.nan, jnp.float32)

  a0 = force(x, prev, jnp.float32(config.start_cap))
  state0 = (x, jnp.zeros_like(x), a0, jnp.float32(config.dt),
            jnp.float32(config.alpha), 0, jnp.float32(config.start_cap))

  def chunk(carry):
    state, chunk_idx, e_hist, streak = carry
    state = jax.lax.fori_loop(0, config.num_iters,
                              lambda t, s: fire_step(s, prev), state)
    x, v = state[0], state[1]
    v_mag = jnp.linalg.norm(v, axis=0)
    e_hist = e_hist.at[chunk_idx].set(jnp.sum(v_mag**2))
    v_max = jnp.max(v_mag)
    cap = state[-1]
    # Require TWO consecutive converged boundaries: FIRE zeroes
    # velocities on an uphill step, so a single boundary landing right
    # after a reset can show a transiently-tiny v_max without the mesh
    # being anywhere near equilibrium (the finer the chunks, the more
    # boundaries sample that window).
    conv = (v_max < config.stop_v_max) & (cap >= config.final_cap)
    streak = jnp.where(conv, streak + 1, 0)
    # Escalate the cap when velocities converged but the cap hasn't.
    new_cap = jnp.where(
        (v_max < config.stop_v_max) & (cap < config.final_cap),
        jnp.minimum(cap * config.cap_scale, config.final_cap), cap)
    state = state[:-1] + (new_cap,)
    return state, chunk_idx + 1, e_hist, streak

  def cond(carry):
    _, chunk_idx, _, streak = carry
    return (streak < 2) & (chunk_idx < max_chunks)

  state, chunks, e_hist, _ = jax.lax.while_loop(
      cond, chunk, (state0, 0, e_kin0, jnp.int32(0)))
  return state[0], e_hist, chunks * config.num_iters
