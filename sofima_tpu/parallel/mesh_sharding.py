"""Multi-chip spatially-sharded mesh relaxation (shard_map + ICI halos).

The reference solves each mesh on a single device and scales out only by
z-blocks (SURVEY.md §2.6). Here the relaxation *stencil itself* is sharded
across a device mesh: the [2 or 3, z, y, x] node grid is split along y,
every integration step exchanges a 1-row halo with ring neighbors via
`lax.ppermute` (rides ICI on real hardware), and FIRE's global scalars
(power, v_max, drift means) become `psum`/`pmax` collectives.

Boundary contract: missing halos at the global grid edges are NaN, which
`mesh._spring_force` already treats as absent springs, so the sharded
force field is bitwise-equivalent (modulo reduction order) to the
single-device computation.
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sofima_tpu import mesh as mesh_lib

shard_map = jax.shard_map if hasattr(jax, 'shard_map') else (
    jax.experimental.shard_map.shard_map)


def _halo_pad(x_local: jnp.ndarray, axis_name: str,
              spatial_axis: int) -> jnp.ndarray:
  """Pads the local block with 1-slice halos from ring neighbors.

  `spatial_axis` is the array axis being exchanged (negative ok). Edge
  devices receive NaN halos (= no springs across the global boundary).
  """
  n = jax.lax.axis_size(axis_name)
  idx = jax.lax.axis_index(axis_name)
  ax = spatial_axis % x_local.ndim

  first = jax.lax.slice_in_dim(x_local, 0, 1, axis=ax)
  last = jax.lax.slice_in_dim(
      x_local, x_local.shape[ax] - 1, x_local.shape[ax], axis=ax)

  if n > 1:
    # Send my last slice forward (to i+1) -> becomes their lead halo.
    halo_lead = jax.lax.ppermute(
        last, axis_name, [(i, i + 1) for i in range(n - 1)])
    # Send my first slice backward (to i-1) -> their trail halo.
    halo_trail = jax.lax.ppermute(
        first, axis_name, [(i + 1, i) for i in range(n - 1)])
  else:
    halo_lead = first
    halo_trail = last

  halo_lead = jnp.where(idx == 0, jnp.nan, halo_lead)
  halo_trail = jnp.where(idx == n - 1, jnp.nan, halo_trail)
  return jnp.concatenate([halo_lead, x_local, halo_trail], axis=ax)


def _halo_pad_y(x_local: jnp.ndarray, axis_name: str) -> jnp.ndarray:
  return _halo_pad(x_local, axis_name, -2)


def _sharded_force_2d(axis_name: str, base_force=None):
  """Wraps an in-plane force with per-step 1-row halo exchange.

  `base_force` defaults to the XLA stencil; any force with the same
  signature runs per shard (halo rows arrive via ppermute).
  """
  if base_force is None:
    base_force = mesh_lib.inplane_force

  def force(x_local, k, stride, prefer_orig_order=False):
    padded = _halo_pad(x_local, axis_name, -2)
    f = base_force(padded, k, stride, prefer_orig_order)
    y_axis = f.ndim - 2
    return jax.lax.slice_in_dim(f, 1, f.shape[y_axis] - 1, axis=y_axis)
  return force


def _sharded_force_2d_grid(axis_y: str, axis_x: str, base_force=None,
                           dim: int = 2):
  """2-D (y, x)-sharded stencil force: sequential halo exchanges.

  The x exchange runs on the already-y-padded block, so the corner
  nodes travel two hops (y neighbor then x neighbor) and the diagonal
  spring families see correct corner halos — the standard 2-D stencil
  decomposition. For pod-scale square meshes this halves the surface-
  to-volume ratio of 1-D strips. Works for the in-plane force (dim=2)
  and the volumetric 26-neighbor force (dim=3, z unsharded — LICONN
  tile meshes are shallow in z): the 3d edge/corner links only ever
  reach 1 node diagonally in (y, x), which the two-hop corner transport
  covers for every z plane at once.
  """
  if base_force is None:
    base_force = (mesh_lib.inplane_force if dim == 2
                  else mesh_lib.elastic_mesh_3d)

  def force(x_local, k, stride, prefer_orig_order=False):
    padded = _halo_pad(x_local, axis_y, -2)
    padded = _halo_pad(padded, axis_x, -1)
    f = base_force(padded, k, stride, prefer_orig_order)
    f = jax.lax.slice_in_dim(f, 1, f.shape[-2] - 1, axis=f.ndim - 2)
    return jax.lax.slice_in_dim(f, 1, f.shape[-1] - 1, axis=f.ndim - 1)
  return force


def _sharded_force_3d(axis_name: str, base_force=None):
  if base_force is None:
    base_force = mesh_lib.elastic_mesh_3d

  def force(x_local, k, stride, prefer_orig_order=False):
    padded = _halo_pad(x_local, axis_name, -2)
    f = base_force(padded, k, stride, prefer_orig_order)
    y_axis = f.ndim - 2
    return jax.lax.slice_in_dim(f, 1, f.shape[y_axis] - 1, axis=y_axis)
  return force


def make_mesh(n_devices: int | None = None,
              axis_name: str = 'mesh_y') -> Mesh:
  devices = jax.devices()
  if n_devices is not None:
    devices = devices[:n_devices]
  return Mesh(np.array(devices), (axis_name,))


def make_mesh_2d(ny: int, nx: int, axis_y: str = 'mesh_y',
                 axis_x: str = 'mesh_x') -> Mesh:
  """2-D device mesh for (y, x)-sharded relaxation."""
  devices = np.array(jax.devices()[:ny * nx]).reshape(ny, nx)
  return Mesh(devices, (axis_y, axis_x))


def relax_mesh_sharded(
    x: jnp.ndarray,
    prev: jnp.ndarray | None,
    config: mesh_lib.IntegrationConfig,
    device_mesh: Mesh,
    axis_name: str = 'mesh_y',
    dim: int = 2,
    base_force=None,
):
  """Relaxes a y-sharded mesh to convergence entirely on device.

  Semantics of `mesh.relax_mesh_fused`, with the node grid split along y
  over `device_mesh` and per-step 1-row halo exchange. The y extent must
  be divisible by the device count.

  Args:
    x: [2 or 3, z, y, x] initial positions (global array)
    prev: optional [2 or 3, z, y, x] zero-length spring targets
    config: integration parameters (FIRE required)
    device_mesh: 1d jax.sharding.Mesh
    axis_name: mesh axis to shard y over
    dim: 2 for in-plane forces, 3 for the volumetric stencil

  Returns:
    (x_final, e_kin history [max_chunks], steps executed)
  """
  if not config.fire:
    raise NotImplementedError('Sharded relaxation requires FIRE.')
  two_d = len(device_mesh.axis_names) == 2
  axis_y = device_mesh.axis_names[0] if two_d else axis_name
  axis_x = device_mesh.axis_names[1] if two_d else None
  n_dev = device_mesh.shape[axis_y]
  n_dev_x = device_mesh.shape[axis_x] if two_d else 1
  # Auto-pad indivisible extents with NaN rows/cols: NaN nodes are
  # "absent" to the spring stencil (no forces, zero velocity), so the
  # padded solve matches the unpadded one exactly; the global
  # reductions below are NaN-aware so drift removal ignores padding.
  orig_y = x.shape[-2]
  orig_x = x.shape[-1]
  pad_y = (-orig_y) % n_dev
  pad_x = (-orig_x) % n_dev_x
  if pad_y or pad_x:
    widths = [(0, 0)] * (x.ndim - 2) + [(0, pad_y), (0, pad_x)]
    x = jnp.pad(x, widths, constant_values=np.nan)
    if prev is not None:
      prev = jnp.pad(prev, widths, constant_values=np.nan)

  if two_d:
    force_fn = _sharded_force_2d_grid(axis_y, axis_x, base_force, dim=dim)
    all_axes = (axis_y, axis_x)
  else:
    force_fn = (_sharded_force_2d(axis_y, base_force) if dim == 2
                else _sharded_force_3d(axis_y, base_force))
    all_axes = (axis_y,)

  def psum(v):
    return jax.lax.psum(v, all_axes)

  def pmean_keepdims(v, axes):
    # NaN-aware: padded/absent nodes must not poison drift removal.
    finite = jnp.isfinite(v)
    local = jnp.sum(jnp.where(finite, v, 0.0), axis=axes, keepdims=True)
    count = jnp.sum(finite.astype(jnp.float32), axis=axes,
                    keepdims=True)
    return psum(local) / jnp.maximum(psum(count), 1.0)

  spec = P(*([None] * (x.ndim - 2) + [axis_y, axis_x]))
  has_prev = prev is not None

  max_chunks = int(np.ceil(config.max_iters / config.num_iters))

  @functools.partial(
      shard_map, mesh=device_mesh,
      in_specs=(spec, spec) if has_prev else (spec,),
      out_specs=(spec, P(None), P()))
  def run(x_local, *maybe_prev):
    prev_local = maybe_prev[0] if maybe_prev else None
    force, _, fire_step = mesh_lib._make_step_fns(
        config, force_fn, None, reduce_fn=psum, mean_fn=pmean_keepdims)

    a0 = force(x_local, prev_local, jnp.float32(config.start_cap))
    state0 = (x_local, jnp.zeros_like(x_local), a0, jnp.float32(config.dt),
              jnp.float32(config.alpha), 0, jnp.float32(config.start_cap))
    e_kin0 = jnp.full((max_chunks,), jnp.nan, jnp.float32)

    def chunk(carry):
      state, chunk_idx, e_hist, streak = carry
      state = jax.lax.fori_loop(
          0, config.num_iters, lambda t, s: fire_step(s, prev_local), state)
      v = state[1]
      v_sq = jnp.sum(jnp.square(v), axis=0)
      e_hist = e_hist.at[chunk_idx].set(psum(jnp.sum(v_sq)))
      v_max = jnp.sqrt(jax.lax.pmax(jnp.max(v_sq), all_axes))
      cap = state[-1]
      # Two consecutive converged boundaries (see mesh.relax_mesh_fused).
      conv = (v_max < config.stop_v_max) & (cap >= config.final_cap)
      streak = jnp.where(conv, streak + 1, 0)
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

  with device_mesh:
    sharding = NamedSharding(device_mesh, spec)
    x = jax.device_put(x, sharding)
    if has_prev:
      prev = jax.device_put(prev, sharding)
      out, e_hist, steps = run(x, prev)
    else:
      out, e_hist, steps = run(x)
  if pad_y or pad_x:
    out = out[..., :orig_y, :orig_x]
  return out, e_hist, steps


def sharded_flow_step(device_mesh: Mesh, axis_name: str = 'mesh_y'):
  """Returns a jitted data-parallel batched xcorr+peaks step.

  The patch batch is sharded across devices (pure DP: images replicated,
  starts and outputs split) — the scale-out axis for flow estimation.
  """
  from sofima_tpu import flow_field

  def step(pre_image, post_image, starts, patch_size):
    return flow_field.batched_xcorr_peaks(
        pre_image, post_image, None, None, patch_size, starts, mean=None)

  def run(pre_image, post_image, starts, patch_size):
    batch_spec = NamedSharding(device_mesh, P(axis_name, None))
    repl = NamedSharding(device_mesh, P(None, None))
    pre_image = jax.device_put(pre_image, repl)
    post_image = jax.device_put(post_image, repl)
    starts = jax.device_put(starts, batch_spec)
    with device_mesh:
      return jax.jit(step, static_argnames=['patch_size'])(
          pre_image, post_image, starts, patch_size)

  return run


def dense_flow_field_sharded(
    device_mesh: Mesh,
    pre_image,
    post_image,
    patch_size: tuple[int, int],
    step: tuple[int, int],
    batch_size: int = 1024,
    axis_name: str = 'mesh_y',
    **flow_kwargs,
):
  """Spatially-sharded dense flow grid over a 2d section pair.

  The scale-out path for whole-section flow estimation: both images are
  sharded along y across the device mesh; each device exchanges a
  (patch - step)-row halo with its +y neighbor over ICI (ppermute) and
  computes its strip of the flow grid with `dense_flow_field` — zero
  host round trips, output grid sharded along y.

  Requirements: the image height must be divisible by n_devices, and the
  per-device strip height by step[0] (pad the section if needed).

  Returns [dim+2, gy, gx] on the global grid, identical to the
  single-device `dense_flow_field` result.
  """
  from sofima_tpu import flow_field

  n_dev = int(np.prod([device_mesh.shape[a] for a in device_mesh.axis_names]))
  h, w = pre_image.shape
  assert post_image.shape == pre_image.shape, 'sharded mode: equal shapes'
  py, px = int(patch_size[0]), int(patch_size[1])
  sy, sx = int(step[0]), int(step[1])
  # Global grid from the ORIGINAL extent (rows touching auto-padding are
  # cropped below).
  gy = (h - (py - sy)) // sy
  gx = (w - (px - sx)) // sx
  # Auto-pad: each device strip must be step-aligned. Padded rows are
  # zero image / invalid mask, and every grid row they could influence
  # lies beyond `gy`, so the crop restores exact single-device results.
  unit = n_dev * sy
  h_pad = -(-h // unit) * unit
  if h_pad != h:
    extra = ((0, h_pad - h), (0, 0))
    pre_image = jnp.pad(jnp.asarray(pre_image, jnp.float32), extra)
    post_image = jnp.pad(jnp.asarray(post_image, jnp.float32), extra)
    for key in ('pre_mask', 'post_mask'):
      if flow_kwargs.get(key) is not None:
        flow_kwargs[key] = jnp.pad(
            jnp.asarray(flow_kwargs[key]).astype(bool), extra,
            constant_values=True)
    h = h_pad
  h_loc = h // n_dev
  halo = py - sy

  # Send each device's TOP halo rows to the PREVIOUS device; the last
  # device receives zeros (its tail grid rows are cropped anyway).
  perm = [(i, i - 1) for i in range(1, n_dev)]

  # Pixel masks (invalid=True) are sharded and halo-exchanged like the
  # images. Note zero-fill on the last device's halo marks those pixels
  # VALID; the affected tail grid rows are cropped, so this is benign.
  pre_mask = flow_kwargs.pop('pre_mask', None)
  post_mask = flow_kwargs.pop('post_mask', None)
  masks = [m for m in (pre_mask, post_mask) if m is not None]
  for m in masks:
    assert m.shape == pre_image.shape, 'masks must match the image shape'

  def local(pre_l, post_l, *mask_l):
    def with_halo(img):
      if halo == 0:
        return img
      top = jax.lax.ppermute(img[:halo], axis_name, perm)
      return jnp.concatenate([img, top], axis=0)

    mask_kw = {}
    it = iter(mask_l)
    if pre_mask is not None:
      mask_kw['pre_mask'] = with_halo(next(it)) > 0
    if post_mask is not None:
      mask_kw['post_mask'] = with_halo(next(it)) > 0
    return flow_field.dense_flow_field(
        with_halo(pre_l), with_halo(post_l), (py, px), (sy, sx),
        batch_size=batch_size, **mask_kw, **flow_kwargs)

  n_in = 2 + len(masks)
  shard_fn = functools.partial(
      shard_map, mesh=device_mesh,
      in_specs=(P(axis_name, None),) * n_in,
      out_specs=P(None, axis_name, None))

  spec = NamedSharding(device_mesh, P(axis_name, None))
  pre_image = jax.device_put(jnp.asarray(pre_image, jnp.float32), spec)
  post_image = jax.device_put(jnp.asarray(post_image, jnp.float32), spec)
  mask_args = [
      jax.device_put(jnp.asarray(m, jnp.uint8), spec) for m in masks]
  with device_mesh:
    out = jax.jit(shard_fn(local))(pre_image, post_image, *mask_args)
  return out[:, :gy, :gx]
