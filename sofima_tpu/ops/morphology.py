"""Morphological primitives as device programs.

JAX replacements for the scipy.ndimage CPU routines the reference
uses for flow cleaning (/root/reference/flow_utils.py:74,121,129):
median filtering (sorted stack of shifted views), connected-component
labeling (iterative min-label propagation), and binary morphology via
moving-window reductions.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _shifted_stack(x: jnp.ndarray, radius: int, dims: int,
                   fill) -> jnp.ndarray:
  """Stacks all (2r+1)^dims shifted views of the trailing `dims` axes."""
  offsets = [0]
  views = []

  def rec(axis, arr):
    if axis == dims:
      views.append(arr)
      return
    ax = x.ndim - dims + axis
    for off in range(-radius, radius + 1):
      pad = [(0, 0)] * x.ndim
      if off > 0:
        pad[ax] = (off, 0)
        shifted = jnp.pad(arr, pad, constant_values=fill)
        shifted = jax.lax.slice_in_dim(shifted, 0, x.shape[ax], axis=ax)
      elif off < 0:
        pad[ax] = (0, -off)
        shifted = jnp.pad(arr, pad, constant_values=fill)
        shifted = jax.lax.slice_in_dim(
            shifted, -off, shifted.shape[ax], axis=ax)
      else:
        shifted = arr
      rec(axis + 1, shifted)

  rec(0, x)
  del offsets
  return jnp.stack(views)


@functools.partial(jax.jit, static_argnames=['dims', 'radius'])
def median_filter(x: jnp.ndarray, dims: int = 2,
                  radius: int = 1) -> jnp.ndarray:
  """Moving median over the trailing `dims` axes ((2r+1)^dims window).

  Border handling replicates the edge (mode='nearest').
  """
  stack = _shifted_stack(x, radius, dims, fill=np.nan)
  # Replace out-of-bounds NaN fills with the center value so the median
  # window effectively shrinks at the border.
  center = x[None]
  stack = jnp.where(jnp.isnan(stack), center, stack)
  return jnp.median(stack, axis=0)


@functools.partial(jax.jit, static_argnames=['max_iters'])
def label_components(valid: jnp.ndarray, max_iters: int = 0) -> jnp.ndarray:
  """Labels 4-connected components of a 2d boolean mask.

  Min-label propagation accelerated by pointer jumping: every valid pixel
  starts with its linear index; each round takes the minimum over its
  valid 4-neighborhood and then follows its current label to that pixel's
  label (`lab <- labels_flat[lab]`, a parallel shortcut in the
  union-find forest). The combination converges in O(log n) rounds even
  for serpentine components whose geodesic diameter is O(h*w), where
  plain neighborhood propagation needs O(h*w) passes. Runs as one
  `lax.while_loop` device program, exiting at the true fixed point.
  Returns int32 labels (invalid pixels get -1); label values are
  arbitrary but unique per component.
  """
  h, w = valid.shape
  n = h * w
  init = jnp.where(valid, jnp.arange(n, dtype=jnp.int32).reshape(h, w), n)
  if max_iters <= 0:
    # Generous safety ceiling; with pointer jumping the fixed point is
    # reached in ~2*log2(n) rounds, and the while_loop exits there.
    max_iters = h + w

  def neighbor_min(lab):
    big = jnp.int32(n)
    out = lab
    for axis, off in ((0, 1), (0, -1), (1, 1), (1, -1)):
      pad = [(0, 0), (0, 0)]
      if off > 0:
        pad[axis] = (1, 0)
        s = jnp.pad(lab, pad, constant_values=big)
        s = jax.lax.slice_in_dim(s, 0, lab.shape[axis], axis=axis)
      else:
        pad[axis] = (0, 1)
        s = jnp.pad(lab, pad, constant_values=big)
        s = jax.lax.slice_in_dim(s, 1, s.shape[axis], axis=axis)
      out = jnp.minimum(out, s)
    return jnp.where(valid, out, big)

  def jump(lab):
    # lab values are linear pixel indices within the same component, so
    # following them to that pixel's (smaller-or-equal) label is safe.
    padded = jnp.concatenate([lab.reshape(-1), jnp.array([n], jnp.int32)])
    return jnp.where(valid, jnp.minimum(lab, padded[lab].reshape(h, w)),
                     jnp.int32(n))

  def cond(state):
    lab, prev_lab, it = state
    return (it < max_iters) & jnp.any(lab != prev_lab)

  def body(state):
    lab, _, it = state
    new = jump(jump(neighbor_min(lab)))
    return new, lab, it + 1

  lab0 = neighbor_min(init)
  lab, _, _ = jax.lax.while_loop(cond, body, (lab0, init, 0))
  return jnp.where(valid, lab, -1)


@jax.jit
def component_sizes(labels: jnp.ndarray) -> jnp.ndarray:
  """Per-pixel size of the component each pixel belongs to (-1 -> 0)."""
  h, w = labels.shape
  n = h * w
  flat = labels.reshape(-1)
  safe = jnp.where(flat < 0, n, flat)
  counts = jnp.zeros(n + 1, jnp.int32).at[safe].add(1)
  counts = counts.at[n].set(0)
  return counts[safe].reshape(h, w)


@functools.partial(jax.jit, static_argnames=['min_size'])
def small_component_mask(valid: jnp.ndarray, min_size: int) -> jnp.ndarray:
  """True where a valid pixel belongs to a component smaller than min_size."""
  labels = label_components(valid)
  sizes = component_sizes(labels)
  return valid & (sizes < min_size)
