"""Optical-flow estimation via masked cross-correlation, on device.

Reimplements the capability of the reference flow estimator
(/root/reference/flow_field.py): normalized masked FFT cross-correlation
over batches of patch pairs (after D. Padfield, "Masked Object Registration
in the Fourier Domain", IEEE TIP 2012), batched top-2 peak extraction with
sharpness/ratio statistics, and a grid-driven flow-field driver with
targeting-field support.

Design differences from the reference:
  * The whole per-image computation is ONE device program: a `lax.map`
    over fixed-size patch batches (patch gather → masked xcorr → peak
    stats), instead of a host loop dispatching per batch and scattering
    per-point on the host (/root/reference/flow_field.py:610-709). Results
    come back in a single device->host transfer and are scattered with one
    vectorized assignment.
  * FFT sizes are padded to 5-smooth lengths.
  * Peak second-maximum suppression is computed per batch row (the
    reference's column-wise suppression can cross-talk between rows).

Data contracts preserved exactly (verified against the reference's test
vectors): flow maps 'post' to 'pre' (post + flow = pre), channel order of
the output is x, y[, z], sharpness, peak_ratio; flow vectors have integer
pixel precision; invalid entries are NaN.
"""

from __future__ import annotations

import collections.abc
import functools
from typing import Callable, Iterator, Sequence, TypeVar

import jax
import jax.numpy as jnp
import numpy as np

from sofima_tpu.utils import geom

Array = np.ndarray | jnp.ndarray
T = TypeVar('T')


def next_fast_len(n: int) -> int:
  """Smallest 5-smooth (2^a 3^b 5^c) integer >= n — fast for XLA FFT."""
  if n <= 2:
    return max(n, 1)
  best = 1 << (n - 1).bit_length()  # power of two upper bound
  p5 = 1
  while p5 < best:
    p35 = p5
    while p35 < best:
      # Smallest power of two lifting p35 above n.
      q = -(-n // p35)
      p2 = 1 << max(q - 1, 0).bit_length()
      best = min(best, p2 * p35)
      p35 *= 3
    p5 *= 5
  return best


def _spatial_reverse(x: Array, dim: int) -> Array:
  return x[(Ellipsis,) + (slice(None, None, -1),) * dim]


def masked_xcorr(
    prev: Array,
    curr: Array,
    prev_mask: Array | None = None,
    curr_mask: Array | None = None,
    use_jax: bool = True,
    dim: int = 2,
    per_item: bool = False,
) -> Array:
  """Normalized cross-correlation between two (optionally masked) images.

  Correlation runs over the last `dim` axes; leading axes are batch.
  Masks mark INVALID pixels (True = ignore). Where masks are present the
  output is the masked normalized cross-correlation in [-1, 1]; regions
  whose valid-pixel overlap is below 30% of the maximum overlap are zeroed.

  `per_item=True` evaluates the overlap/denominator thresholds per batch
  item instead of over the whole batch. The default (False) matches the
  reference semantics (/root/reference/flow_field.py:36-156), where a
  batch of patches shares one global threshold; per-item mode makes a
  batched call bit-equivalent to a sequence of batch-of-1 calls, which
  is what the batched coarse-offset path needs (each tile pair must see
  exactly the thresholds it would see alone).

  Capability parity with /root/reference/flow_field.py:36-156; written as
  a single jnp program so it fuses under jit.
  """
  full_shape = tuple(
      int(a + b - 1)
      for a, b in zip(prev.shape[-dim:], curr.shape[-dim:]))
  fft_shape = tuple(next_fast_len(s) for s in full_shape)
  out_slice = (Ellipsis,) + tuple(slice(0, s) for s in full_shape)

  prev = jnp.asarray(prev, jnp.float32)
  curr = jnp.asarray(curr, jnp.float32)

  if prev_mask is not None:
    prev_mask = jnp.asarray(prev_mask)
    prev = jnp.where(prev_mask, 0.0, prev)
  if curr_mask is not None:
    curr_mask = jnp.asarray(curr_mask)
    curr = jnp.where(curr_mask, 0.0, curr)

  curr = _spatial_reverse(curr, dim)

  fft = functools.partial(jnp.fft.rfftn, s=fft_shape)
  ifft = functools.partial(jnp.fft.irfftn, s=fft_shape)

  f_prev = fft(prev)
  f_curr = fft(curr)
  xcorr = ifft(f_prev * f_curr)

  if prev_mask is None and curr_mask is None:
    result = xcorr[out_slice]
    return result if use_jax else np.asarray(result)

  valid_prev = (jnp.ones(prev.shape, bool) if prev_mask is None
                else jnp.logical_not(prev_mask))
  valid_curr = (jnp.ones(curr.shape, bool) if curr_mask is None
                else _spatial_reverse(jnp.logical_not(curr_mask), dim))

  f_vp = fft(valid_prev)
  f_vc = fft(valid_curr)

  eps = jnp.float32(np.finfo(np.float32).eps)
  overlap = jnp.fmax(jnp.round(ifft(f_vc * f_vp)), eps)
  inv_overlap = 1.0 / overlap

  # Local (masked-region) sums of each image under the other's mask.
  sum_prev = ifft(f_vc * f_prev)
  sum_curr = ifft(f_vp * f_curr)

  numerator = xcorr - sum_prev * sum_curr * inv_overlap

  var_prev = jnp.fmax(
      ifft(f_vc * fft(jnp.square(prev))) - jnp.square(sum_prev) * inv_overlap,
      0.0)
  var_curr = jnp.fmax(
      ifft(f_vp * fft(jnp.square(curr))) - jnp.square(sum_curr) * inv_overlap,
      0.0)
  denom = jnp.sqrt(var_prev * var_curr)

  numerator = numerator[out_slice]
  denom = denom[out_slice]
  overlap = overlap[out_slice]

  max_axes = tuple(range(-dim, 0)) if per_item else None
  tol = 1e3 * eps * jnp.max(jnp.abs(denom), axis=max_axes, keepdims=True)
  result = jnp.where(denom > tol, numerator / jnp.where(denom > tol, denom, 1.0),
                     0.0)
  result = jnp.clip(result, -1.0, 1.0)
  result = jnp.where(
      overlap < 0.3 * jnp.max(overlap, axis=max_axes, keepdims=True), 0.0,
      result)
  return result if use_jax else np.asarray(result)


def _integral_image(mask):
  """Summed-area table (see utils.geom); kept for API discoverability."""
  return geom.integral_image(mask)


def _max_filter(img: jnp.ndarray, size: Sequence[int],
                padding: str = 'SAME') -> jnp.ndarray:
  """Separable moving-maximum over the trailing len(size) axes."""
  dim = len(size)
  out = img
  for i, s in enumerate(size):
    window = [1] * img.ndim
    window[img.ndim - dim + i] = int(s)
    out = jax.lax.reduce_window(
        out, -jnp.inf, jax.lax.max, window, [1] * img.ndim, padding)
  return out


def _peak_window_min(img: jnp.ndarray, peak_idx: jnp.ndarray,
                     peak_radius: Sequence[int]) -> jnp.ndarray:
  """Min over the (2r+1)^dim window around each peak, clamped in-bounds.

  Exactly reproduces the reference's per-peak dynamic_slice window
  (/root/reference/flow_field.py:192: the window is SHIFTED to stay
  inside the image at borders) as a VALID-padded separable min-filter
  indexed at the clamped window start — one dense filter plus a single
  1-element gather per image, instead of a vmapped dynamic_slice that
  XLA lowers to per-peak gathers.

  Args:
    img: [b, *spatial] correlation images
    peak_idx: [b] flattened peak positions
    peak_radius: per-axis window radius

  Returns:
    [b] window minima
  """
  dim = img.ndim - 1
  spatial = img.shape[1:]
  sizes = [2 * int(r) + 1 for r in peak_radius]
  minf = -_max_filter(-img, sizes, padding='VALID')
  valid_shape = minf.shape[1:]

  inds = jnp.unravel_index(peak_idx, spatial)
  lin = jnp.zeros_like(peak_idx)
  for ind, size, n, vn in zip(inds, sizes, spatial, valid_shape):
    start = jnp.clip(ind - size // 2, 0, n - size)
    lin = lin * vn + start
  flat = minf.reshape(img.shape[0], -1)
  return jnp.take_along_axis(flat, lin[:, None], axis=-1)[:, 0]


def _batched_peaks(
    img: jnp.ndarray,
    center_offset: Sequence[int],
    min_distance: int | Sequence[int] = 2,
    threshold_rel: float = 0.5,
    peak_radius: int | Sequence[int] = 5,
) -> jnp.ndarray:
  """Top-2 local maxima + stats for a batch of correlation images.

  Args:
    img: [b, [z,] y, x] correlation images
    center_offset: ([z,] y, x) location of the zero-shift peak
    min_distance: min peak separation (scalar or per-axis)
    threshold_rel: peaks must exceed this fraction of the per-image max
    peak_radius: window radius for the sharpness statistic

  Returns:
    [b, dim+2] array: x, y[, z] offset from center, sharpness, peak ratio
    (0 when only one peak; NaN row when no peak).
  """
  dim = img.ndim - 1
  if isinstance(min_distance, collections.abc.Sequence):
    size = [2 * int(m) + 1 for m in min_distance]
  else:
    size = [2 * int(min_distance) + 1] * dim
  if not isinstance(peak_radius, collections.abc.Sequence):
    peak_radius = (int(peak_radius),) * dim

  img_max = _max_filter(img, size)
  axes = tuple(range(-dim, 0))
  thresholds = threshold_rel * jnp.max(img, axis=axes, keepdims=True)
  peak_mask = (img == img_max) & (img > thresholds)

  flat = jnp.where(peak_mask, img, -jnp.inf).reshape(img.shape[0], -1)
  idx1 = jnp.argmax(flat, axis=-1)
  val1 = jnp.take_along_axis(flat, idx1[:, None], axis=-1)[:, 0]
  # Per-row suppression of the first peak before finding the second.
  cols = jnp.arange(flat.shape[-1])[None, :]
  flat2 = jnp.where(cols == idx1[:, None], -jnp.inf, flat)
  idx2 = jnp.argmax(flat2, axis=-1)
  val2 = jnp.take_along_axis(flat2, idx2[:, None], axis=-1)[:, 0]

  # Vectorized per-peak statistics (no per-image dynamic windows).
  offset = np.asarray(center_offset)
  inds = jnp.unravel_index(idx1, img.shape[1:])
  centered = [ind.astype(jnp.float32) - off
              for ind, off in zip(inds, offset)]
  sharpness = val1 / _peak_window_min(img, idx1, peak_radius)
  ratio = jnp.where(jnp.isinf(val2), 0.0, val1 / val2)
  rows = jnp.stack(centered[::-1] + [sharpness, ratio], axis=-1)
  return jnp.where(jnp.isinf(val1)[:, None], jnp.nan, rows)


def _batched_xcorr(
    pre_image: jnp.ndarray,
    post_image: jnp.ndarray,
    pre_mask: jnp.ndarray | None,
    post_mask: jnp.ndarray | None,
    patch_size: Sequence[int],
    starts: jnp.ndarray,
    mean: float | None,
    post_patch_size: Sequence[int] | None = None,
    post_starts: jnp.ndarray | None = None,
) -> tuple[np.ndarray, jnp.ndarray]:
  """Gathers patch pairs at `starts` and cross-correlates them.

  Returns (zero-shift peak location, [b, *xcorr_shape] correlations).
  """
  if post_patch_size is None:
    post_patch_size = patch_size
  if post_starts is None:
    post_starts = starts

  def gather(image, pos, size):
    return jax.vmap(lambda p: jax.lax.dynamic_slice(image, p, size))(pos)

  pre_batch = gather(pre_image, starts, patch_size)
  post_batch = gather(post_image, post_starts, post_patch_size)
  pre_mask_b = (None if pre_mask is None
                else gather(pre_mask, starts, patch_size))
  post_mask_b = (None if post_mask is None
                 else gather(post_mask, post_starts, post_patch_size))

  axes = tuple(range(-len(patch_size), 0))

  def masked_mean(batch, mask):
    if mask is None:
      return jnp.mean(batch, axis=axes, keepdims=True)
    return jnp.nanmean(jnp.where(mask, jnp.nan, batch), axis=axes,
                       keepdims=True)

  if mean is None:
    pre_mean = masked_mean(pre_batch, pre_mask_b)
    post_mean = masked_mean(post_batch, post_mask_b)
  else:
    pre_mean = post_mean = mean

  center = (np.array(patch_size) + np.array(post_patch_size)) // 2 - 1
  xc = masked_xcorr(
      pre_batch - pre_mean,
      post_batch - post_mean,
      pre_mask_b,
      post_mask_b,
      use_jax=True,
      dim=len(patch_size))
  return center, xc


@functools.partial(
    jax.jit,
    static_argnames=[
        'patch_size', 'mean', 'min_distance', 'threshold_rel', 'peak_radius',
        'post_patch_size'
    ])
def batched_xcorr_peaks(
    pre_image: jnp.ndarray,
    post_image: jnp.ndarray,
    pre_mask: jnp.ndarray | None,
    post_mask: jnp.ndarray | None,
    patch_size: Sequence[int],
    starts: jnp.ndarray,
    mean: float | None,
    min_distance: int | Sequence[int] = 2,
    threshold_rel: float = 0.5,
    peak_radius: int | Sequence[int] = 5,
    post_patch_size: Sequence[int] | None = None,
    post_starts: jnp.ndarray | None = None,
) -> jnp.ndarray:
  """Fused gather → masked xcorr → peak-stats kernel (one jit program)."""
  center, xc = _batched_xcorr(pre_image, post_image, pre_mask, post_mask,
                              patch_size, starts, mean, post_patch_size,
                              post_starts)
  return _batched_peaks(xc, center, min_distance, threshold_rel, peak_radius)


def _silent_fn(x: list[T]) -> Iterator[T]:
  yield from x


@functools.lru_cache(maxsize=8)
def _dft_mats(n: int) -> tuple[np.ndarray, np.ndarray]:
  """Real/imag parts of the n-point DFT matrix (host-cached constants)."""
  k = np.arange(n)
  ang = -2.0 * np.pi * np.outer(k, k) / n
  return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _rdft_mats(n: int):
  """Half-spectrum DFT matrices exploiting real-input symmetry.

  Returns (fr, fi) [n, h] for the forward rDFT (h = n//2 + 1 retained
  frequencies) and (br, bi) [h, n] for the inverse with the Hermitian
  doubling weights folded in: x = br^T-style reconstruction
  x[m] = sum_k alpha_k (Re F_k cos + Im F_k (-sin)) with alpha = 1 at DC
  and Nyquist, 2 elsewhere.
  """
  h = n // 2 + 1
  k = np.arange(h)
  m = np.arange(n)
  ang = -2.0 * np.pi * np.outer(m, k) / n  # [n, h]
  fr = np.cos(ang).astype(np.float32)
  fi = np.sin(ang).astype(np.float32)
  alpha = np.full(h, 2.0, np.float32)
  alpha[0] = 1.0
  if n % 2 == 0:
    alpha[-1] = 1.0
  br = (np.cos(-ang) * alpha[None]).astype(np.float32).T  # [h, n]
  bi = (-np.sin(-ang) * alpha[None]).astype(np.float32).T
  return fr, fi, br, bi


def _circular_xcorr_matmul(pre_b: jnp.ndarray,
                           post_b: jnp.ndarray,
                           bf16: bool = False) -> jnp.ndarray:
  """Circular cross-correlation via DFT-as-matmul.

  For patch-sized transforms the DFT matrices are small, so the
  transform runs as dense batched matmuls on the matrix units. Uses the
  half-spectrum (rfft) form along the last axis — real inputs need only
  n//2+1 frequencies. Computes irfft(F(pre) * conj(F(post))) exactly (up
  to float32 rounding).

  With `bf16=True` the matmul INPUTS are bfloat16 while accumulation
  stays float32: mean-subtracted EM patches lose <0.5% relative
  amplitude to the 8-bit mantissa, which does not move integer
  correlation peaks (asserted by the bf16-vs-f32 parity test in
  tests/test_flow_field.py). Without it the matmuls run at full float32
  precision (a GPU would otherwise round float32 operands to TF32).
  """
  n1, n2 = pre_b.shape[-2:]
  in_t = jnp.bfloat16 if bf16 else jnp.float32
  wr1, wi1 = (jnp.asarray(m, in_t) for m in _dft_mats(n1))
  fr2, fi2, br2, bi2 = (jnp.asarray(m, in_t) for m in _rdft_mats(n2))

  mm = functools.partial(
      jnp.einsum, preferred_element_type=jnp.float32,
      precision=None if bf16 else jax.lax.Precision.HIGHEST)

  def rdft2(img):
    # Last axis: half-spectrum rDFT; first axis: full DFT.
    img = img.astype(in_t)
    ar = mm('bnm,mh->bnh', img, fr2).astype(in_t)
    ai = mm('bnm,mh->bnh', img, fi2).astype(in_t)
    fr = mm('kn,bnh->bkh', wr1, ar) - mm('kn,bnh->bkh', wi1, ai)
    fi = mm('kn,bnh->bkh', wr1, ai) + mm('kn,bnh->bkh', wi1, ar)
    return fr, fi

  pr, pi = rdft2(pre_b)
  qr, qi = rdft2(post_b)
  # F(pre) * conj(F(post)) on the half spectrum.
  cr = (pr * qr + pi * qi).astype(in_t)
  ci = (pi * qr - pr * qi).astype(in_t)

  # Inverse: full complex inverse along the first axis (conj(W1)/n1),
  # then the Hermitian-weighted inverse along the last axis.
  gr = ((mm('kn,bnh->bkh', wr1, cr) + mm('kn,bnh->bkh', wi1, ci))
        / n1).astype(in_t)
  gi = ((mm('kn,bnh->bkh', wr1, ci) - mm('kn,bnh->bkh', wi1, cr))
        / n1).astype(in_t)
  out = (mm('bkh,hm->bkm', gr, br2) + mm('bkh,hm->bkm', gi, bi2)) / n2
  return out


def _rdft2(img: jnp.ndarray):
  """Half-spectrum 2d DFT via f32 matmuls; returns (re, im) [b, n1, h2]."""
  n1, n2 = img.shape[-2:]
  wr1, wi1 = (jnp.asarray(m) for m in _dft_mats(n1))
  fr2, fi2, _, _ = (jnp.asarray(m) for m in _rdft_mats(n2))
  mm = functools.partial(jnp.einsum, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
  ar = mm('bnm,mh->bnh', img, fr2)
  ai = mm('bnm,mh->bnh', img, fi2)
  fr = mm('kn,bnh->bkh', wr1, ar) - mm('kn,bnh->bkh', wi1, ai)
  fi = mm('kn,bnh->bkh', wr1, ai) + mm('kn,bnh->bkh', wi1, ar)
  return fr, fi


def _irdft2_of_product(a, b, n1: int, n2: int):
  """real(iDFT2( A * conj(B) )) for half-spectrum (re, im) pairs."""
  wr1, wi1 = (jnp.asarray(m) for m in _dft_mats(n1))
  _, _, br2, bi2 = (jnp.asarray(m) for m in _rdft_mats(n2))
  mm = functools.partial(jnp.einsum, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
  ar_, ai_ = a
  br_, bi_ = b
  cr = ar_ * br_ + ai_ * bi_
  ci = ai_ * br_ - ar_ * bi_
  gr = (mm('kn,bnh->bkh', wr1, cr) + mm('kn,bnh->bkh', wi1, ci)) / n1
  gi = (mm('kn,bnh->bkh', wr1, ci) - mm('kn,bnh->bkh', wi1, cr)) / n1
  return (mm('bkh,hm->bkm', gr, jnp.asarray(br2))
          + mm('bkh,hm->bkm', gi, jnp.asarray(bi2))) / n2


def _masked_xcorr_circular(pre_b, post_b, pre_valid, post_valid):
  """Circular masked NCC (Padfield) via DFT matmuls.

  All correlation terms of the Padfield normalization
  (/root/reference/flow_field.py:61-156 describes the linear version)
  become circular correlations of the masked images and their
  valid-pixel masks, evaluated with half-spectrum DFT matmuls:
  6 forward transforms + 6 inverse transforms per patch pair.
  """
  n1, n2 = pre_b.shape[-2:]
  eps = jnp.float32(np.finfo(np.float32).eps)

  pre_z = jnp.where(pre_valid, pre_b, 0.0)
  post_z = jnp.where(post_valid, post_b, 0.0)

  f_p = _rdft2(pre_z)
  f_c = _rdft2(post_z)
  f_mp = _rdft2(pre_valid.astype(jnp.float32))
  f_mc = _rdft2(post_valid.astype(jnp.float32))
  f_p2 = _rdft2(jnp.square(pre_z))
  f_c2 = _rdft2(jnp.square(post_z))

  xcorr = _irdft2_of_product(f_p, f_c, n1, n2)
  overlap = jnp.fmax(jnp.round(_irdft2_of_product(f_mp, f_mc, n1, n2)),
                     eps)
  inv_overlap = 1.0 / overlap
  sum_p = _irdft2_of_product(f_p, f_mc, n1, n2)
  sum_c = _irdft2_of_product(f_mp, f_c, n1, n2)

  numerator = xcorr - sum_p * sum_c * inv_overlap
  var_p = jnp.fmax(
      _irdft2_of_product(f_p2, f_mc, n1, n2)
      - jnp.square(sum_p) * inv_overlap, 0.0)
  var_c = jnp.fmax(
      _irdft2_of_product(f_mp, f_c2, n1, n2)
      - jnp.square(sum_c) * inv_overlap, 0.0)
  denom = jnp.sqrt(var_p * var_c)

  tol = 1e3 * eps * jnp.max(jnp.abs(denom), keepdims=True)
  out = jnp.where(denom > tol,
                  numerator / jnp.where(denom > tol, denom, 1.0), 0.0)
  out = jnp.clip(out, -1.0, 1.0)
  return jnp.where(overlap < 0.3 * jnp.max(overlap, keepdims=True), 0.0,
                   out)


def _masked_xcorr_circular_fft(pre_b, post_b, pre_valid, post_valid,
                               patch_size):
  """Dim-generic circular masked NCC (Padfield) via FFTs.

  The N-d twin of `_masked_xcorr_circular` (which routes the 2d case
  through DFT matmuls): identical Padfield term structure
  (/root/reference/flow_field.py:61-156 is the linear-correlation
  original; here every term is a circular correlation on the
  patch-periodic torus), with the transforms as rfftn over the last
  `len(patch_size)` axes — XLA's FFT handles any rank, so 3d masked
  LICONN overlaps ride the same fast strip path as unmasked.
  """
  dim = len(patch_size)
  axes = tuple(range(-dim, 0))
  eps = jnp.float32(np.finfo(np.float32).eps)

  pre_z = jnp.where(pre_valid, pre_b, 0.0)
  post_z = jnp.where(post_valid, post_b, 0.0)

  f_p = jnp.fft.rfftn(pre_z, axes=axes)
  f_c = jnp.fft.rfftn(post_z, axes=axes)
  f_mp = jnp.fft.rfftn(pre_valid.astype(jnp.float32), axes=axes)
  f_mc = jnp.fft.rfftn(post_valid.astype(jnp.float32), axes=axes)
  f_p2 = jnp.fft.rfftn(jnp.square(pre_z), axes=axes)
  f_c2 = jnp.fft.rfftn(jnp.square(post_z), axes=axes)

  def icorr(a, b):
    return jnp.fft.irfftn(a * jnp.conj(b), s=patch_size, axes=axes)

  xcorr = icorr(f_p, f_c)
  overlap = jnp.fmax(jnp.round(icorr(f_mp, f_mc)), eps)
  inv_overlap = 1.0 / overlap
  sum_p = icorr(f_p, f_mc)
  sum_c = icorr(f_mp, f_c)

  numerator = xcorr - sum_p * sum_c * inv_overlap
  var_p = jnp.fmax(icorr(f_p2, f_mc) - jnp.square(sum_p) * inv_overlap,
                   0.0)
  var_c = jnp.fmax(icorr(f_mp, f_c2) - jnp.square(sum_c) * inv_overlap,
                   0.0)
  denom = jnp.sqrt(var_p * var_c)

  tol = 1e3 * eps * jnp.max(jnp.abs(denom), keepdims=True)
  out = jnp.where(denom > tol,
                  numerator / jnp.where(denom > tol, denom, 1.0), 0.0)
  out = jnp.clip(out, -1.0, 1.0)
  return jnp.where(overlap < 0.3 * jnp.max(overlap, keepdims=True), 0.0,
                   out)


def _circular_peaks(
    pre_b: jnp.ndarray,
    post_b: jnp.ndarray,
    mean: float | None,
    min_distance,
    threshold_rel: float,
    peak_radius,
    pre_valid: jnp.ndarray | None = None,
    post_valid: jnp.ndarray | None = None,
    dft_matmul: bool = False,
    bf16: bool = False,
    peak_crop: int | None = None,
) -> jnp.ndarray:
  """Circular correlation + peak stats of a [b, *patch] patch-pair batch.

  Shared core of every circular path (start lists, strips, targeted):
  per-patch mean removal (masked when validity masks are given), the
  patch-periodic correlation — masked Padfield NCC, DFT-as-matmul (2d)
  or FFT — and the top-2 peak statistics. `peak_crop` (even) restricts
  the peak search to the centered [peak_crop]^dim core of the surface.
  """
  patch_size = tuple(pre_b.shape[1:])
  dim = len(patch_size)
  axes = tuple(range(-dim, 0))

  def masked_mean(batch, valid):
    if valid is None:
      return jnp.mean(batch, axis=axes, keepdims=True)
    count = jnp.maximum(jnp.sum(valid, axis=axes, keepdims=True), 1)
    return (jnp.sum(jnp.where(valid, batch, 0.0), axis=axes,
                    keepdims=True) / count)

  if mean is None:
    pre_b = pre_b - masked_mean(pre_b, pre_valid)
    post_b = post_b - masked_mean(post_b, post_valid)
  else:
    pre_b = pre_b - mean
    post_b = post_b - mean

  if pre_valid is not None or post_valid is not None:
    if pre_valid is None:
      pre_valid = jnp.ones_like(pre_b, bool)
    if post_valid is None:
      post_valid = jnp.ones_like(post_b, bool)
    if dim == 2:
      corr = _masked_xcorr_circular(pre_b, post_b, pre_valid, post_valid)
    else:
      corr = _masked_xcorr_circular_fft(pre_b, post_b, pre_valid,
                                        post_valid, patch_size)
  elif dft_matmul and dim == 2:
    corr = _circular_xcorr_matmul(pre_b, post_b, bf16=bf16)
  else:
    f_pre = jnp.fft.rfftn(pre_b, axes=axes)
    f_post = jnp.fft.rfftn(post_b, axes=axes)
    corr = jnp.fft.irfftn(f_pre * jnp.conj(f_post), s=patch_size,
                          axes=axes)
  # corr[s] = sum_t pre(t + s) * post(t): the peak sits at s = pre - post.
  # Center the zero-shift bin so peak reporting matches the linear path.
  center = tuple(p // 2 for p in patch_size)
  corr = jnp.roll(corr, center, axis=axes)
  if peak_crop is not None:
    pc = int(peak_crop)
    if not (0 < pc <= min(patch_size) and pc % 2 == 0):
      raise ValueError('peak_crop must be even and <= patch size')
    corr = corr[(slice(None),)
                + tuple(slice(c - pc // 2, c + pc // 2) for c in center)]
    center = (pc // 2,) * dim
  return _batched_peaks(corr, center, min_distance, threshold_rel,
                        peak_radius)


@functools.partial(
    jax.jit,
    static_argnames=['patch_size', 'mean', 'min_distance', 'threshold_rel',
                     'peak_radius', 'dft_matmul'])
def _batched_xcorr_peaks_circular(
    pre_image: jnp.ndarray,
    post_image: jnp.ndarray,
    patch_size: Sequence[int],
    starts: jnp.ndarray,
    mean: float | None,
    min_distance: int | Sequence[int] = 2,
    threshold_rel: float = 0.5,
    peak_radius: int | Sequence[int] = 5,
    post_starts: jnp.ndarray | None = None,
    dft_matmul: bool = False,
    pre_mask: jnp.ndarray | None = None,
    post_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
  """Circular-correlation fast path: patch-sized FFTs (no padding).

  Computes the cross-correlation on the patch-periodic torus — ~4x less
  FFT work than the zero-padded linear correlation. Valid for shifts up
  to ±patch/2 (beyond that linear correlation peaks are unreliable too);
  wrap-around products slightly perturb off-peak values, which in
  practice does not move integer peak locations for textured data.
  Output format matches `batched_xcorr_peaks`.
  """
  if post_starts is None:
    post_starts = starts

  def gather(image, pos):
    return jax.vmap(
        lambda p: jax.lax.dynamic_slice(image, p, patch_size))(pos)

  pre_b = gather(jnp.asarray(pre_image, jnp.float32), starts)
  post_b = gather(jnp.asarray(post_image, jnp.float32), post_starts)
  pre_valid = post_valid = None
  if pre_mask is not None:
    pre_valid = jnp.logical_not(gather(jnp.asarray(pre_mask), starts))
  if post_mask is not None:
    post_valid = jnp.logical_not(
        gather(jnp.asarray(post_mask), post_starts))
  return _circular_peaks(pre_b, post_b, mean, min_distance, threshold_rel,
                         peak_radius, pre_valid, post_valid,
                         dft_matmul=dft_matmul)


def _strip_patches(strip: jnp.ndarray, rows: int, grid_x: int,
                   patch: tuple[int, int],
                   step: tuple[int, int]) -> jnp.ndarray:
  """Rearranges an image strip into its dense patch batch WITHOUT gathers.

  When the stride divides the patch size (the production EM geometry,
  160/40), every patch is a contiguous group of stride-sized blocks, so
  patch extraction is pure reshape + static slicing — sequential HBM
  copies instead of the random-access gather XLA emits for
  vmap(dynamic_slice).

  Args:
    strip: [(rows-1)*step_y + patch_y, (grid_x-1)*step_x + patch_x] image
    rows: number of consecutive grid rows covered by the strip
    grid_x: patches per grid row
    patch: (py, px) patch size
    step: (sy, sx) grid step; py % sy == 0 and px % sx == 0

  Returns:
    [rows * grid_x, py, px] patch batch, row-major over (row, gx).
  """
  py, px = patch
  sy, sx = step
  ry, rx = py // sy, px // sx
  h, w = strip.shape
  nby = h // sy
  nbx = w // sx
  blocks = strip.reshape(nby, sy, nbx, sx)
  # Horizontal assembly: patch at column j = blocks j..j+rx-1.
  parts = [blocks[:, :, b:b + grid_x, :] for b in range(rx)]
  horiz = jnp.stack(parts, axis=3)  # [nby, sy, grid_x, rx, sx]
  horiz = horiz.transpose(2, 0, 1, 3, 4).reshape(grid_x, nby, sy, px)
  # Vertical assembly: patch at row i = block-rows i..i+ry-1.
  vparts = [horiz[:, b:b + rows, :, :] for b in range(ry)]
  vert = jnp.stack(vparts, axis=2)  # [grid_x, rows, ry, sy, px]
  vert = vert.transpose(1, 0, 2, 3, 4).reshape(rows, grid_x, py, px)
  return vert.reshape(rows * grid_x, py, px)


def _strip_patches_3d(slab: jnp.ndarray, grid_y: int, grid_x: int,
                      patch: tuple[int, int, int],
                      step: tuple[int, int, int]) -> jnp.ndarray:
  """[pz, strip_h, strip_w] slab -> [gy*gx, pz, py, px], gather-free.

  The z extent of the slab IS the patch depth (one grid z-row), so only
  the in-plane assembly is needed: the 2d reshape/stack trick
  (_strip_patches) vmapped over z planes.
  """
  pz, py, px = patch
  _, sy, sx = step
  planes = jax.vmap(
      lambda p: _strip_patches(p, grid_y, grid_x, (py, px), (sy, sx)))(
          slab)  # [pz, gy*gx, py, px]
  return jnp.moveaxis(planes, 0, 1)


@functools.partial(
    jax.jit,
    static_argnames=['patch_size', 'step', 'mean', 'min_distance',
                     'threshold_rel', 'peak_radius'])
def _dense_flow_strips_3d(
    pre_image: jnp.ndarray,
    post_image: jnp.ndarray,
    patch_size: tuple[int, int, int],
    step: tuple[int, int, int],
    mean: float | None,
    min_distance,
    threshold_rel: float,
    peak_radius,
    pre_mask: jnp.ndarray | None = None,
    post_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
  """Dense circular 3d flow via strip-sliced patches (device resident).

  The 3d twin of `_dense_flow_strips`: a lax.map over grid z-rows; each
  step slices one [pz, strip_h, strip_w] slab (a single dynamic_slice),
  assembles every patch of the z-row with reshape/stack slicing (no
  gathers — the vmap(dynamic_slice) start-list path XLA lowers to
  scalar gather code), and runs patch-periodic FFT correlation + the
  dim-general peak extractor. Replaces the reference's treatment of 3d
  as leading batch axes over scattered starts
  (/root/reference/flow_field.py:44-47) with one device scan.

  Circular (patch-periodic) correlation: integer peaks match the
  padfield path for in-range shifts — the same contract the 2d
  circular fast path ships under (tests/test_flow_field.py).

  With masks the per-patch correlation is the dim-generic circular
  Padfield NCC (_masked_xcorr_circular_fft) — the masked 3d LICONN
  regime rides the same gather-free strip assembly instead of falling
  back to the scattered-start padfield driver.
  """
  pz, py, px = patch_size
  sz, sy, sx = step
  d, h, w = pre_image.shape
  gz = (d - (pz - sz)) // sz
  gy = (h - (py - sy)) // sy
  gx = (w - (px - sx)) // sx
  strip_h = (gy - 1) * sy + py
  strip_w = (gx - 1) * sx + px
  pre_image = jnp.asarray(pre_image, jnp.float32)
  post_image = jnp.asarray(post_image, jnp.float32)
  z0s = jnp.arange(gz, dtype=jnp.int32) * sz

  def one_zrow(z0):
    def patches(img):
      slab = jax.lax.dynamic_slice(img, (z0, 0, 0),
                                   (pz, strip_h, strip_w))
      return _strip_patches_3d(slab, gy, gx, patch_size, step)

    a = patches(pre_image)
    b = patches(post_image)
    va = vb = None
    if pre_mask is not None:
      va = patches(pre_mask.astype(jnp.float32)) <= 0
    if post_mask is not None:
      vb = patches(post_mask.astype(jnp.float32)) <= 0

    return _circular_peaks(a, b, mean, min_distance, threshold_rel,
                           peak_radius, va, vb)

  peaks = jax.lax.map(one_zrow, z0s)  # [gz, gy*gx, 5]
  out = peaks.reshape(gz, gy, gx, 5)
  return jnp.moveaxis(out, -1, 0)


@functools.partial(
    jax.jit,
    static_argnames=['patch_size', 'step', 'mean', 'min_distance',
                     'threshold_rel', 'peak_radius', 'rows_per_step',
                     'dft_matmul', 'bf16'])
def _dense_flow_strips(
    pre_image: jnp.ndarray,
    post_image: jnp.ndarray,
    patch_size: tuple[int, int],
    step: tuple[int, int],
    mean: float | None,
    min_distance,
    threshold_rel: float,
    peak_radius,
    rows_per_step: int = 2,
    dft_matmul: bool = True,
    bf16: bool = False,
    pre_mask: jnp.ndarray | None = None,
    post_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
  """Dense circular flow over the full grid via strip-sliced patches.

  The production dense-grid hot path: a `lax.map` over groups of
  `rows_per_step` grid rows; each step slices a contiguous image strip
  (one dynamic_slice), rearranges it into the patch batch with
  `_strip_patches` (zero gathers), and runs the DFT-matmul correlation +
  peak extraction.
  """
  py, px = patch_size
  sy, sx = step
  gy = (pre_image.shape[0] - (py - sy)) // sy
  gx = (pre_image.shape[1] - (px - sx)) // sx
  num_steps = -(-gy // rows_per_step)
  strip_h = (rows_per_step - 1) * sy + py
  strip_w = (gx - 1) * sx + px

  row0 = jnp.arange(num_steps, dtype=jnp.int32) * (rows_per_step * sy)
  # Clamp the last strip so it stays in bounds; the duplicated rows it
  # recomputes are cropped after the map.
  row0 = jnp.minimum(row0, (gy - rows_per_step) * sy)

  pre_image = jnp.asarray(pre_image, jnp.float32)
  post_image = jnp.asarray(post_image, jnp.float32)

  def one_strip(y0):
    def patches(img):
      strip = jax.lax.dynamic_slice(img, (y0, 0), (strip_h, strip_w))
      return _strip_patches(strip, rows_per_step, gx, patch_size, step)

    pre_valid = post_valid = None
    if pre_mask is not None:
      pre_valid = jnp.logical_not(patches(pre_mask.astype(jnp.float32)) > 0)
    if post_mask is not None:
      post_valid = jnp.logical_not(
          patches(post_mask.astype(jnp.float32)) > 0)
    return _circular_peaks(patches(pre_image), patches(post_image), mean,
                           min_distance, threshold_rel, peak_radius,
                           pre_valid, post_valid, dft_matmul=dft_matmul,
                           bf16=bf16)

  peaks = jax.lax.map(one_strip, row0)  # [steps, rows*gx, dim+2]
  peaks = peaks.reshape(num_steps, rows_per_step, gx, 4)
  # Undo the last-strip clamp: rebuild the row axis by true grid row.
  out = jnp.zeros((gy, gx, 4), peaks.dtype)
  rows = (row0[:, None] // sy + jnp.arange(rows_per_step)[None, :])
  out = out.at[rows.reshape(-1)].set(
      peaks.reshape(num_steps * rows_per_step, gx, 4))
  return jnp.moveaxis(out, -1, 0)


@functools.partial(
    jax.jit,
    static_argnames=['patch_size', 'step', 'max_offset', 'origin', 'mean',
                     'bf16', 'min_distance', 'threshold_rel', 'peak_radius',
                     'peak_crop', 'batch_size'])
def targeted_flow_peaks(
    pre_image: jnp.ndarray,
    post_image: jnp.ndarray,
    post_offsets: jnp.ndarray,
    patch_size: tuple[int, int],
    step: tuple[int, int],
    max_offset: int,
    origin: tuple[int, int] = (0, 0),
    mean: float | None = None,
    bf16: bool = False,
    min_distance: int = 2,
    threshold_rel: float = 0.5,
    peak_radius: int = 5,
    peak_crop: int | None = None,
    batch_size: int = 4096,
) -> jnp.ndarray:
  """Grid flow peaks with a per-node integer POST patch offset.

  The reference's targeting-field mechanism
  (/root/reference/flow_field.py:487-490, 626-677) on a regular grid:
  node (i, j) correlates the pre patch starting at origin + (i, j) * step
  with the post patch starting at the same position plus
  `post_offsets[i, j]` ((dy, dx), clipped to +-max_offset; post pixels
  outside the image read as zeros). Integer shifts are exact, so the
  capture range grows by the offset with no resampling. The grid has
  `post_offsets.shape[:2]` nodes and must lie inside `pre_image`.

  Returns [4, gy, gx]: x/y peaks RELATIVE to the shifted post patches
  (subtract the offsets for absolute flow), sharpness and peak ratio.
  `peak_crop` restricts the peak search to the centered core of each
  correlation surface (see `_circular_peaks`); size it well above the
  expected residual.
  """
  sy, sx = step
  gy, gx = post_offsets.shape[:2]
  md = int(max_offset)
  offs = jnp.clip(post_offsets.astype(jnp.int32), -md, md).reshape(-1, 2)
  node_y = origin[0] + jnp.arange(gy, dtype=jnp.int32) * sy
  node_x = origin[1] + jnp.arange(gx, dtype=jnp.int32) * sx
  starts = jnp.stack(jnp.meshgrid(node_y, node_x, indexing='ij'),
                     axis=-1).reshape(-1, 2)
  post_starts = starts + offs + md

  n = gy * gx
  batch = min(batch_size, n)
  num_batches = -(-n // batch)
  pad = ((0, num_batches * batch - n), (0, 0))
  starts = jnp.pad(starts, pad, mode='edge')
  post_starts = jnp.pad(post_starts, pad, mode='edge')

  pre = jnp.asarray(pre_image, jnp.float32)
  post = jnp.pad(jnp.asarray(post_image, jnp.float32), md)

  def gather(image, pos):
    return jax.vmap(
        lambda p: jax.lax.dynamic_slice(image, p, patch_size))(pos)

  def one_batch(args):
    ps, qs = args
    return _circular_peaks(gather(pre, ps), gather(post, qs), mean,
                           min_distance, threshold_rel, peak_radius,
                           dft_matmul=True, bf16=bf16, peak_crop=peak_crop)

  peaks = jax.lax.map(one_batch, (starts.reshape(num_batches, batch, 2),
                                  post_starts.reshape(num_batches, batch,
                                                      2)))
  peaks = peaks.reshape(num_batches * batch, 4)[:n]
  return jnp.moveaxis(peaks.reshape(gy, gx, 4), -1, 0)


@functools.partial(
    jax.jit,
    static_argnames=['patch_size', 'step', 'batch_size', 'mean',
                     'min_distance', 'threshold_rel', 'peak_radius',
                     'post_patch_size', 'circular', 'dft_matmul', 'bf16'])
def dense_flow_field(
    pre_image: jnp.ndarray,
    post_image: jnp.ndarray,
    patch_size: Sequence[int],
    step: Sequence[int],
    batch_size: int = 1024,
    mean: float | None = None,
    min_distance: int | Sequence[int] = 2,
    threshold_rel: float = 0.5,
    peak_radius: int | Sequence[int] = 5,
    post_patch_size: Sequence[int] | None = None,
    circular: bool = False,
    dft_matmul: bool = False,
    bf16: bool = False,
    pre_mask: jnp.ndarray | None = None,
    post_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
  """Flow field over the full dense patch grid, entirely on device.

  The production hot path for unmasked dense grids: patch start
  generation, the batched xcorr+peaks scan, and the grid reshape all run
  inside ONE jit program — zero host round trips (the result stays on
  device; fetch reductions, not the full grid, when bandwidth matters).

  With `circular=True` the correlation runs on the patch-periodic torus
  (patch-sized FFTs, ~4x faster; see _batched_xcorr_peaks_circular);
  requires equal pre/post patch sizes.

  Masked note: the masked-NCC denominator tolerance and the low-overlap
  cut use per-dispatch-batch maxima (mirroring the reference, whose
  result depends on what shared a batch); they equal the per-patch
  rules whenever any patch of the batch is fully valid — the production
  regime.

  Returns [dim+2, *grid] with the same conventions as
  `JAXMaskedXCorrWithStatsCalculator.flow_field`.
  """
  ndim = pre_image.ndim
  patch_size = tuple(patch_size)
  step = tuple(step)
  if post_patch_size is None:
    post_patch_size = patch_size
  else:
    post_patch_size = tuple(post_patch_size)

  grid = tuple(
      (post_image.shape[a] - (post_patch_size[a] - step[a])) // step[a]
      for a in range(ndim))

  # Gather-free 3d strip path (LICONN fine stitching geometry).
  if (circular and ndim == 3 and post_patch_size == patch_size
      and all(p % s == 0 for p, s in zip(patch_size, step))
      and pre_image.shape == post_image.shape):
    return _dense_flow_strips_3d(
        jnp.asarray(pre_image, jnp.float32),
        jnp.asarray(post_image, jnp.float32), patch_size, step, mean,
        min_distance, threshold_rel, peak_radius,
        pre_mask=pre_mask, post_mask=post_mask)

  # Gather-free strip path: stride divides patch (production geometry).
  if (circular and ndim == 2 and post_patch_size == patch_size
      and patch_size[0] % step[0] == 0 and patch_size[1] % step[1] == 0
      and pre_image.shape == post_image.shape):
    rows = max(1, min(int(grid[0]),
                      int(round(batch_size / max(int(grid[1]), 1))) or 1))
    return _dense_flow_strips(
        jnp.asarray(pre_image, jnp.float32),
        jnp.asarray(post_image, jnp.float32),
        patch_size, step, mean, min_distance, threshold_rel, peak_radius,
        rows_per_step=rows, dft_matmul=dft_matmul, bf16=bf16,
        pre_mask=pre_mask, post_mask=post_mask)
  n = int(np.prod(grid))
  batch_size = min(batch_size, n)
  num_batches = -(-n // batch_size)
  padded = num_batches * batch_size

  # All patch starts, row-major over the grid ([z]yx coords).
  axes = [jnp.arange(g, dtype=jnp.int32) * s for g, s in zip(grid, step)]
  starts = jnp.stack(jnp.meshgrid(*axes, indexing='ij'),
                     axis=-1).reshape(n, ndim)
  starts = jnp.pad(starts, ((0, padded - n), (0, 0)), mode='edge')

  patch_offset = jnp.asarray(
      [(patch_size[a] - post_patch_size[a]) // 2 for a in range(ndim)],
      jnp.int32)
  pre_starts = jnp.maximum(starts - patch_offset[None], 0)

  pre_image = jnp.asarray(pre_image, jnp.float32)
  post_image = jnp.asarray(post_image, jnp.float32)

  if circular and post_patch_size != patch_size:
    raise ValueError('circular mode requires equal pre/post patch sizes')
  if (pre_mask is not None or post_mask is not None) and not circular:
    raise ValueError('dense masked mode requires circular=True')

  def one_batch(args):
    ps, qs = args
    if circular:
      return _batched_xcorr_peaks_circular(
          pre_image, post_image, patch_size, ps, mean,
          min_distance=min_distance, threshold_rel=threshold_rel,
          peak_radius=peak_radius, post_starts=qs,
          dft_matmul=dft_matmul, pre_mask=pre_mask, post_mask=post_mask)
    return batched_xcorr_peaks(
        pre_image, post_image, None, None, patch_size, ps, mean,
        min_distance=min_distance, threshold_rel=threshold_rel,
        peak_radius=peak_radius, post_patch_size=post_patch_size,
        post_starts=qs)

  peaks = jax.lax.map(
      one_batch,
      (pre_starts.reshape(num_batches, batch_size, ndim),
       starts.reshape(num_batches, batch_size, ndim)))
  peaks = peaks.reshape(padded, ndim + 2)[:n]
  return jnp.moveaxis(peaks.reshape(grid + (ndim + 2,)), -1, 0)


@functools.partial(
    jax.jit,
    static_argnames=['patch_size', 'step', 'coarse_step', 'fine_patch',
                     'batch_size', 'bf16', 'max_displacement', 'residual',
                     'min_distance', 'threshold_rel', 'peak_radius',
                     'return_overflow', 'peak_crop', 'prior_step',
                     'prior_origin'])
def coarse_to_fine_flow(
    pre_image: jnp.ndarray,
    post_image: jnp.ndarray,
    patch_size: tuple[int, int] = (160, 160),
    step: tuple[int, int] = (40, 40),
    coarse_step: tuple[int, int] | None = None,
    fine_patch: tuple[int, int] | None = None,
    batch_size: int = 4096,
    bf16: bool = True,
    max_displacement: int = 96,
    residual: int = 8,
    pre_mask: jnp.ndarray | None = None,
    post_mask: jnp.ndarray | None = None,
    min_distance: int = 2,
    threshold_rel: float = 0.5,
    peak_radius: int = 5,
    return_overflow: bool = False,
    peak_crop: int | None = None,
    prior: jnp.ndarray | None = None,
    prior_step: tuple[int, int] | None = None,
    prior_origin: tuple[int, int] | None = None,
) -> jnp.ndarray:
  """Coarse-to-fine dense flow: same grid as `dense_flow_field`, ~2x faster.

  The dense patch-160/stride-40 grid recomputes every pixel 16x, and the
  DFT-matmul correlation core is O(patch^3) per patch — so most of the
  arithmetic buys capture range, not precision. This driver splits the
  two concerns, mirroring the reference's targeting-field mechanism
  (/root/reference/flow_field.py:487-490, 626-677) and its multi-
  resolution pipeline (notebook cell 11: flow at 1x AND 2x):

    1. COARSE: full patches on a `coarse_step` (default patch-sized)
       grid — 1/16 the patches, full +-patch/2 capture range;
    2. the median-filtered, NaN-filled coarse flow, sampled at each fine
       node center and rounded, gives that node an integer post-patch
       offset (`targeted_flow_peaks`; exact, no resampling);
    3. FINE: half-size patches at the original stride measure the
       residual (a few px), at ~1/3 the FLOPs/patch;
    4. total flow = fine peak - the node's integer offset.

  Returns [4, gy, gx] on exactly the `dense_flow_field(patch_size, step)`
  grid (same node centers). Flow components are integers; sharpness/
  ratio statistics come from the fine pass.

  Static envelopes: |coarse flow| is clipped to `max_displacement`. On
  the masked path, `residual` bounds the local variation of the coarse
  field across a tile of the integer transport (raise it for very
  high-frequency deformations). `peak_crop` (even, unmasked targeted
  path only) restricts the FINE peak search to the centered
  [peak_crop, peak_crop] correlation core — size it well above the
  expected fine residual (>= 4x `residual` is safe in practice).

  With `return_overflow=True` also returns a bool scalar flagging that
  a static envelope was exceeded somewhere: on the targeted path, a
  coarse prior beyond `max_displacement` (the fine patch was targeted
  at the clipped offset); on the masked path, a transport tile whose
  prior variation exceeds the `residual` envelope.

  Warm start (`prior`): skip the coarse
  pass entirely and target the fine windows from an externally supplied
  flow prior — e.g. the previous section pair's flow in a serial stack
  (temporal coherence; see pipeline.stack_align warm_start). `prior` is
  [2+, cy_n, cx_n] with prior[0] = dx, prior[1] = dy (the
  dense_flow_field channel convention) on a grid with spacing
  `prior_step` whose node (0, 0) sits at pixel `prior_origin`
  (defaults: `coarse_step` / patch-center origin, i.e. a coarse-pass-
  shaped prior). NaNs are median-filled and the prior is median-
  filtered and clipped exactly like a coarse-pass result; the fine
  pass re-measures peaks exactly, so a stale prior costs capture
  margin (peaks must stay within the fine surface / `peak_crop` core),
  never accuracy. On the masked path the prior drives the integer-shift
  transport in place of the coarse field (same origin-<=-step
  constraint as coarse-pass priors), so masked production streams skip
  the coarse pass too.
  """
  from sofima_tpu.ops import interp as interp_ops
  from sofima_tpu.ops import shift_warp

  py, px = patch_size
  sy, sx = step
  if coarse_step is None:
    coarse_step = patch_size
  if fine_patch is None:
    fine_patch = (py // 2, px // 2)
  csy, csx = coarse_step
  fy, fx = fine_patch
  if csy != csx:
    raise ValueError('coarse_step must be isotropic')
  if fy > py or fx > px:
    raise ValueError('fine_patch must not exceed patch_size')
  # Fine-grid alignment: run the fine pass on a cropped image so its
  # node centers (crop + fine_patch/2 + i*step) land exactly on the
  # target grid (patch_size/2 + i*step) — any fine_patch works, no
  # resampling, no restriction to (py/2 - fy/2) % step == 0 geometries.
  crop_y = (py // 2 - fy // 2) % sy
  crop_x = (px // 2 - fx // 2) % sx
  h, w = pre_image.shape

  if prior is not None:
    cx, cy = prior[0], prior[1]
    csy, csx = prior_step if prior_step is not None else coarse_step
    if csy != csx:
      raise ValueError('prior_step must be isotropic')
  else:
    coarse = dense_flow_field(
        pre_image, post_image, patch_size, coarse_step,
        batch_size=batch_size, circular=True, dft_matmul=True, bf16=bf16,
        pre_mask=pre_mask, post_mask=post_mask, min_distance=min_distance,
        threshold_rel=threshold_rel, peak_radius=peak_radius)
    cx, cy = coarse[0], coarse[1]

  # Robust prior: NaN -> global median, then a 3x3 component-wise median
  # filter to stop isolated wrong coarse peaks from shifting fine windows
  # off target (the fine pass re-measures, so smoothing here only costs
  # capture margin, never accuracy).
  def robustify(c):
    med = jnp.nan_to_num(jnp.nanmedian(c))
    c = jnp.where(jnp.isfinite(c), c, med)
    p = jnp.pad(c, 1, mode='edge')
    stacked = jnp.stack([p[i:i + c.shape[0], j:j + c.shape[1]]
                         for i in range(3) for j in range(3)])
    c = jnp.sort(stacked, axis=0)[4]
    return jnp.clip(c, -max_displacement, max_displacement)

  cx = robustify(cx)
  cy = robustify(cy)
  if prior is not None and prior_origin is not None:
    cy0, cx0 = prior_origin
  else:
    cy0, cx0 = py // 2, px // 2  # first node center

  gy = (h - (py - sy)) // sy
  gx = (w - (px - sx)) // sx

  def maybe_overflow(flow, ovf):
    return (flow, ovf) if return_overflow else flow

  if pre_mask is None and post_mask is None:
    # TARGETED fine pass: each node's post patch is read at round(-coarse)
    # sampled at the node center — an exact integer shift, no resampling,
    # no intermediate warp. Total flow = fine peak - node offset. Node j
    # is centered at patch // 2 + j * step, so its fine patch starts at
    # patch // 2 - fine_patch // 2 + j * step.
    ctr_y = (py // 2 + sy * jnp.arange(gy, dtype=jnp.float32) - cy0) / csy
    ctr_x = (px // 2 + sx * jnp.arange(gx, dtype=jnp.float32) - cx0) / csx
    mesh2 = jnp.stack([jnp.broadcast_to(ctr_y[:, None], (gy, gx)),
                       jnp.broadcast_to(ctr_x[None, :], (gy, gx))])
    offs_raw = jnp.stack([jnp.rint(-interp_ops.grid_sample_linear(cy, mesh2)),
                          jnp.rint(-interp_ops.grid_sample_linear(cx, mesh2))],
                         axis=-1)
    offs = jnp.clip(offs_raw, -max_displacement,
                    max_displacement).astype(jnp.int32)
    overflow = jnp.any(jnp.abs(offs_raw) > max_displacement)
    fine = targeted_flow_peaks(
        pre_image, post_image, offs, fine_patch, step,
        max_offset=max_displacement, origin=(py // 2 - fy // 2,
                                             px // 2 - fx // 2),
        bf16=bf16, min_distance=min_distance, threshold_rel=threshold_rel,
        peak_radius=peak_radius, peak_crop=peak_crop, batch_size=batch_size)
    offs_f = offs.astype(jnp.float32)
    total = jnp.stack([fine[0] - offs_f[..., 1], fine[1] - offs_f[..., 0],
                       fine[2], fine[3]])
    return maybe_overflow(total, overflow)

  k0y = (py // 2 - fy // 2 - crop_y) // sy
  k0x = (px // 2 - fx // 2 - crop_x) // sx

  def fine_crop(img):
    if img is None or (crop_y == 0 and crop_x == 0):
      return img
    return jax.lax.slice(img, (crop_y, crop_x), (h, w))

  # MASKED path: transport post toward pre (post_w(q) = post(q - f)) and
  # run the plain fine pass on the transported pair. Warm-start priors
  # ride the same transport: the prior field (robustified above) plays
  # the coarse pass's role, so masked streams skip the coarse pass too.
  if cy0 > csy or cx0 > csx:
    # The one-node extrapolation below covers a phase deficit of at most
    # one prior cell (origin <= step); anything earlier would need a
    # negative upsample phase that upsample_map_linear does not support.
    # For coarse-pass priors (origin = patch // 2) this is the round-3
    # 'coarse_step >= patch_size // 2' constraint.
    raise ValueError('masked coarse_to_fine requires the coarse/prior '
                     'grid origin to be <= its step '
                     f'(origin ({cy0}, {cx0}), step ({csy}, {csx}))')
  g = jnp.stack([-cy, -cx])  # (y, x) displacement at coarse nodes

  def prepend(v, axis):
    first = jax.lax.slice_in_dim(v, 0, 1, axis=axis)
    second = jax.lax.slice_in_dim(v, 1, 2, axis=axis)
    return jnp.concatenate([2.0 * first - second, v], axis=axis)

  # upsample_map_linear wants non-negative phases; prepending one
  # extrapolated node shifts the grid so phase = scale - center0 >= 0.
  g_ext = prepend(prepend(g, 1), 2)
  # INTEGER-shift transport (the reference's integer-pixel flow
  # semantics, /root/reference/flow_field.py:16-19): round the dense
  # prior to whole pixels so the transport below is an exact gather —
  # the fine pass measures peaks on unresampled data, like the unmasked
  # targeted path (there per-NODE shifts; here per-PIXEL, constant
  # within a coarse cell except at rounding boundaries). The add-back
  # reads the SAME rounded field at each fine node center, so
  # quantization cancels exactly in the total.
  dense_g = jnp.rint(interp_ops.upsample_map_linear(
      g_ext, csy, (csy - cy0, csx - cx0), (h, w)))
  src_y = jnp.arange(h)[:, None] + dense_g[0].astype(jnp.int32)
  src_x = jnp.arange(w)[None, :] + dense_g[1].astype(jnp.int32)
  inside = (src_y >= 0) & (src_y < h) & (src_x >= 0) & (src_x < w)
  src_y = jnp.clip(src_y, 0, h - 1)
  src_x = jnp.clip(src_x, 0, w - 1)

  def transport(plane):
    # Pixels pulled from outside the image read 0.
    return jnp.where(inside, plane[src_y, src_x], 0)

  # The overflow flag keeps its envelope meaning: some transport tile's
  # prior variation exceeds the static `residual` envelope.
  node_y = cy0 + np.arange(cy.shape[0], dtype=np.float64) * csy
  node_x = cx0 + np.arange(cx.shape[1], dtype=np.float64) * csx
  md = -(-max_displacement // 64) * 64
  dplan = shift_warp.tiled_plan_device(
      g[0][None], g[1][None], node_y, node_x, (h, w),
      (-residual, residual, -residual, residual), (-md, md, -md, md))

  post_w = transport(jnp.asarray(post_image, jnp.float32))
  post_mask_w = None
  if post_mask is not None:
    # Invalid-mask transport: pixels pulled from outside the image read
    # 0 (= valid) like the reference's clamped patch windows.
    post_mask_w = transport(jnp.asarray(post_mask, bool))

  fine = dense_flow_field(
      fine_crop(pre_image), fine_crop(post_w), fine_patch, step,
      batch_size=batch_size, circular=True, dft_matmul=True, bf16=bf16,
      pre_mask=fine_crop(pre_mask), post_mask=fine_crop(post_mask_w),
      min_distance=min_distance, threshold_rel=threshold_rel,
      peak_radius=peak_radius)

  fine_c = jax.lax.slice(fine, (0, k0y, k0x), (4, k0y + gy, k0x + gx))

  # Add back the APPLIED (rounded) shift at each fine node center
  # (py//2 + i*sy, px//2 + i*sx): exact cancellation of the transport,
  # matching the unmasked targeted path's peak - window-shift algebra.
  gi_c = jax.lax.slice(dense_g, (0, py // 2, px // 2), (2, h, w),
                       (1, sy, sx))
  gi_c = jax.lax.slice(gi_c, (0, 0, 0), (2, gy, gx))
  total = jnp.stack([fine_c[0] - gi_c[1], fine_c[1] - gi_c[0],
                     fine_c[2], fine_c[3]])
  return maybe_overflow(total, dplan['overflow'])


class JAXMaskedXCorrWithStatsCalculator:
  """Grid-driven flow-field estimator (the #1 hot path).

  API-compatible with the reference calculator
  (/root/reference/flow_field.py:449-712), but the batch loop runs on
  device: all patch start positions are computed up front on the host
  (cheap integer logic incl. targeting-field lookups), then a single
  jitted `lax.map` over fixed-size batches computes every peak, and one
  vectorized scatter fills the output grid.
  """

  non_spatial_flow_channels = 2  # peak sharpness, peak ratio

  def __init__(self, mean: float | None = None, peak_min_distance: float = 2,
               peak_radius: float = 5):
    self._mean = mean
    self._min_distance = peak_min_distance
    self._peak_radius = peak_radius

  def flow_field(
      self,
      pre_image: np.ndarray,
      post_image: np.ndarray,
      patch_size: int | Sequence[int],
      step: int | Sequence[int],
      pre_mask=None,
      post_mask=None,
      mask_only_for_patch_selection: bool = False,
      selection_mask: np.ndarray | None = None,
      max_masked: float = 0.75,
      batch_size: int = 1024,
      post_patch_size: int | Sequence[int] | None = None,
      pre_targeting_field: np.ndarray | None = None,
      pre_targeting_step: int | Sequence[int] | None = None,
      post_targeting_field: np.ndarray | None = None,
      post_targeting_step: int | Sequence[int] | None = None,
      progress_fn: Callable[[list[T]], Iterator[T]] = _silent_fn,
      mode: str = 'padfield',
  ) -> np.ndarray:
    """Computes the flow field from `post` to `pre`.

    Returns a [dim+2, *grid] array (channels: x, y[, z], sharpness, peak
    ratio) on the grid implied by `patch_size`/`step`, NaN where no
    estimate was made. See the module docstring for conventions.

    `mode` selects the correlation backend for dense unmasked runs:
      'padfield'           zero-padded linear correlation (reference parity)
      'circular'           patch-periodic correlation (~4x faster)
      'circular_dft'       circular via DFT-matmuls
      'circular_dft_bf16'  DFT-matmuls with bf16 inputs / f32 accumulation
                           (fastest; integer peaks match circular_dft on
                           textured data — verified by the parity tests)
    Masked / selected / targeted runs always use the padfield path.
    """
    assert pre_image.ndim == post_image.ndim
    ndim = pre_image.ndim

    # Dense fast path: the whole grid in one device program. Masks are
    # supported (2d): occupancy/selection deselection is applied to the
    # result (NaN), and unless mask_only_for_patch_selection the masked
    # circular NCC kernel consumes the pixel masks directly.
    dense_ok = (mode != 'padfield'
                and pre_targeting_field is None
                and post_targeting_field is None
                and (ndim == 2 or (pre_mask is None and post_mask is None
                                   and selection_mask is None)))
    if dense_ok:
      patch_t = tuple((patch_size,) * ndim
                      if not isinstance(patch_size,
                                        collections.abc.Sequence)
                      else patch_size)
      post_patch_t = (tuple(post_patch_size)
                      if isinstance(post_patch_size,
                                    collections.abc.Sequence)
                      else ((post_patch_size,) * ndim
                            if post_patch_size is not None else None))
      step_t = tuple((step,) * ndim
                     if not isinstance(step, collections.abc.Sequence)
                     else step)

      # Host-side deselection (occupancy + explicit selection mask).
      eff_post_patch = post_patch_t or patch_t
      out_shape = (np.array(post_image.shape)
                   - (np.array(eff_post_patch) - step_t)) // step_t
      out_sel = tuple(np.s_[:s] for s in out_shape)
      keep = np.ones(out_shape, dtype=bool)
      if selection_mask is not None:
        keep &= np.array(selection_mask[out_sel], dtype=bool)
      if pre_mask is not None:
        occ = geom.query_integral_image(
            geom.integral_image(pre_mask), patch_t, step_t)
        keep &= ~(occ / np.prod(patch_t) >= max_masked)[out_sel]
      if post_mask is not None:
        occ = geom.query_integral_image(
            geom.integral_image(post_mask), eff_post_patch, step_t)
        keep &= ~(occ / np.prod(eff_post_patch) >= max_masked)[out_sel]

      use_pixel_masks = not mask_only_for_patch_selection
      out = dense_flow_field(
          jnp.asarray(pre_image, jnp.float32),
          jnp.asarray(post_image, jnp.float32),
          patch_t, step_t,
          batch_size=batch_size, mean=self._mean,
          min_distance=self._min_distance, peak_radius=self._peak_radius,
          post_patch_size=post_patch_t,
          circular=True,
          dft_matmul=mode in ('circular_dft', 'circular_dft_bf16'),
          bf16=(mode == 'circular_dft_bf16'),
          pre_mask=(jnp.asarray(pre_mask)
                    if use_pixel_masks and pre_mask is not None else None),
          post_mask=(jnp.asarray(post_mask)
                     if use_pixel_masks and post_mask is not None
                     else None))
      result = np.array(out)
      result[:, ~keep] = np.nan
      return result

    def _vec(v, default=None):
      if v is None:
        return default
      if not isinstance(v, collections.abc.Sequence):
        return (int(v),) * ndim
      return tuple(int(i) for i in v)

    patch_size = _vec(patch_size)
    post_patch_size = _vec(post_patch_size, patch_size)
    step = _vec(step)
    pre_targeting_step = _vec(pre_targeting_step)
    post_targeting_step = _vec(post_targeting_step)

    out_shape = (np.array(post_image.shape)
                 - (np.array(post_patch_size) - step)) // step
    out_sel = tuple(np.s_[:s] for s in out_shape)
    output = np.full([self.non_spatial_flow_channels + ndim]
                     + out_shape.tolist(), np.nan, dtype=np.float32)

    if selection_mask is None:
      selection = np.ones(out_shape, dtype=bool)
    else:
      selection = np.array(selection_mask[out_sel], dtype=bool)

    # Mask-occupancy based patch deselection via integral images.
    if pre_mask is not None:
      occupancy = geom.query_integral_image(
          geom.integral_image(pre_mask), patch_size, step)
      selection &= ~(occupancy / np.prod(patch_size) >= max_masked)[out_sel]
    if post_mask is not None:
      occupancy = geom.query_integral_image(
          geom.integral_image(post_mask), post_patch_size, step)
      selection &= ~(occupancy / np.prod(post_patch_size)
                     >= max_masked)[out_sel]

    if mask_only_for_patch_selection:
      pre_mask = post_mask = None

    coords = np.argwhere(selection)  # [n, ndim], grid coords ([z]yx)
    n = coords.shape[0]
    if n == 0:
      return output

    # --- Host-side integer geometry for all patches at once. -------------
    post_starts = coords * np.asarray(step)[None, :]
    patch_offset = ((np.array(patch_size) - post_patch_size) // 2)[None, :]
    # Keep pre patches in bounds; the shift this introduces is compensated
    # in the returned flow below (the reference clips without compensating,
    # /root/reference/flow_field.py:622-623, which biases border nodes when
    # post_patch_size != patch_size).
    pre_unclamped = post_starts - patch_offset
    pre_starts = np.clip(
        pre_unclamped, 0,
        np.asarray(pre_image.shape)[None, :] - np.asarray(patch_size)[None, :])
    pre_clamp_delta = pre_starts - pre_unclamped

    def _targeting_offsets(field, tstep, starts, psize, img_shape):
      """In-bounds-clamped targeting offsets ([n, ndim], [z]yx order)."""
      center = (np.array(psize) // 2)[None, :]
      query = np.round((starts + center) / np.asarray(tstep)[None, :])
      query = query.astype(int)
      gather_idx = tuple(
          np.clip(query[:, i], 0, field.shape[i + 1] - 1)
          for i in range(ndim))
      offs = np.nan_to_num(field[(slice(None),) + gather_idx].T)
      offs = offs.astype(int)[:, ::-1]  # channels xy[z] -> [z]yx
      new_starts = starts + offs
      offs = offs - np.minimum(new_starts, 0)
      ends = new_starts + np.asarray(psize)[None, :]
      offs = offs - np.maximum(ends - np.asarray(img_shape)[None, :], 0)
      return offs

    tg_offsets = None
    if pre_targeting_field is not None and pre_targeting_step is not None:
      tg_offsets = _targeting_offsets(pre_targeting_field, pre_targeting_step,
                                      pre_starts, patch_size, pre_image.shape)
      pre_starts = pre_starts + tg_offsets

    post_offsets = None
    if post_targeting_field is not None and post_targeting_step is not None:
      post_offsets = _targeting_offsets(post_targeting_field,
                                        post_targeting_step, post_starts,
                                        post_patch_size, post_image.shape)
      post_starts = post_starts + post_offsets

    pre_starts = np.clip(pre_starts, 0, None)
    post_starts = np.clip(post_starts, 0, None)

    # --- One device program over all batches. -----------------------------
    batch_size = int(min(batch_size, max(n, 1)))
    num_batches = -(-n // batch_size)
    padded = num_batches * batch_size
    if padded > n:
      pad = ((0, padded - n), (0, 0))
      pre_starts = np.pad(pre_starts, pad, mode='edge')
      post_starts = np.pad(post_starts, pad, mode='edge')

    pre_j = jnp.asarray(pre_image, jnp.float32)
    post_j = jnp.asarray(post_image, jnp.float32)
    pre_mask_j = None if pre_mask is None else jnp.asarray(pre_mask)
    post_mask_j = None if post_mask is None else jnp.asarray(post_mask)

    kernel = functools.partial(
        batched_xcorr_peaks,
        patch_size=patch_size,
        mean=self._mean,
        min_distance=self._min_distance,
        threshold_rel=0.5,
        peak_radius=self._peak_radius,
        post_patch_size=post_patch_size)

    pre_b = jnp.asarray(pre_starts.reshape(num_batches, batch_size, ndim))
    post_b = jnp.asarray(post_starts.reshape(num_batches, batch_size, ndim))

    def one_batch(args):
      ps, qs = args
      return kernel(pre_j, post_j, pre_mask_j, post_mask_j, starts=ps,
                    post_starts=qs)

    if progress_fn is _silent_fn:
      # Default: the whole batch loop is ONE device dispatch.
      peaks = np.array(jax.lax.map(one_batch, (pre_b, post_b)))
    else:
      # A progress callback asks for per-batch streaming (the reference
      # yields each batch through progress_fn,
      # /root/reference/flow_field.py:610): dispatch batch by batch so
      # the iterator ticks reflect actual completed work. Costs one
      # dispatch per batch instead of one total — only taken when the
      # caller explicitly wants progress.
      parts = [
          np.asarray(one_batch((pre_b[i], post_b[i])))
          for i in progress_fn(list(range(num_batches)))
      ]
      peaks = np.stack(parts)
    peaks = peaks.reshape(padded, ndim + 2)[:n]

    # --- Targeting/clamp corrections + vectorized scatter. ----------------
    if np.any(pre_clamp_delta):
      peaks[:, :ndim] += pre_clamp_delta[:, ::-1]
    if tg_offsets is not None:
      peaks[:, :ndim] += tg_offsets[:, ::-1]
    if post_offsets is not None:
      peaks[:, :ndim] -= post_offsets[:, ::-1]

    output[(slice(None),) + tuple(coords.T)] = peaks.T
    return output
