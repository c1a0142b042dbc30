"""Quantized CPU remap: OpenCV `convertMaps`/`remap` fixed-point contract.

The reference renders through cv2.remap after convertMaps-ing the dense
coordinate map to CV_16SC2 (/root/reference/warp.py:156-165). That path
is NOT float resampling: coordinates are quantized to 1/32 pixel, and
the Lanczos4 taps are 15-bit fixed-point integers with a table-sum
correction — all of which subtly shapes the reference's uint8 outputs.

This module implements that contract in pure numpy so the repo has a
deterministic CPU twin to regression-test against (goldens in
tests/golden/) and a documented tolerance bridge to the float device path:

  * coordinate quantization: sx = round(x * 32); ix = sx >> 5 (floor
    part, saturated to int16), fx = sx & 31 (fraction index) —
    cv::convertMaps with CV_16SC2 + CV_16UC1.
  * Lanczos4 kernel: OpenCV's interpolateLanczos4 closed form (sin/cos
    of x*pi/4 via the rotated-constant table), normalized to sum 1.
  * fixed point: 1d tap tables are built per fraction index; the 2d
    tap table is the outer product rounded to int16 at scale 2^15
    (INTER_REMAP_COEF_SCALE), with the rounding residue added onto the
    largest-magnitude entries so every table sums to exactly 2^15
    (cv::initInterTab2D's correction loop).
  * accumulation: int32 sum of tap * pixel, then (sum + 2^14) >> 15,
    saturated to the uint8 range.

Tolerance contract vs the float path (pinned by tests): for smooth maps
on uint8 data, |quantized - clip(float, 0, 255)| <= 4 gray levels at
any pixel and <= 0.5 on average — the error is dominated by the 1/32
coordinate quantization, not the 15-bit taps. (The uint8 path saturates
Lanczos under/overshoot, exactly like cv2; the float path does not, so
the comparison is against the clipped float result.) Production device
rendering uses the float path; this module is the bit-stable CPU
anchor.
"""

from __future__ import annotations

import functools

import numpy as np

INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS          # 32 fractional positions
COEF_BITS = 15
COEF_SCALE = 1 << COEF_BITS               # 2^15 fixed-point scale


def _lanczos4_coeffs(x: float) -> np.ndarray:
  """OpenCV interpolateLanczos4: 8 taps for fractional position x."""
  s45 = 0.70710678118654752440084436210485
  cs = ((1, 0), (-s45, -s45), (0, 1), (s45, -s45),
        (-1, 0), (s45, s45), (0, -1), (-s45, s45))
  if x < np.finfo(np.float64).eps:
    out = np.zeros(8)
    out[3] = 1.0
    return out
  coeffs = np.empty(8)
  y0 = -(x + 3) * np.pi * 0.25
  s0, c0 = np.sin(y0), np.cos(y0)
  for i in range(8):
    y = -(x + 3 - i) * np.pi * 0.25
    coeffs[i] = (cs[i][0] * s0 + cs[i][1] * c0) / (y * y)
  return coeffs / coeffs.sum()


@functools.lru_cache(maxsize=1)
def _tab2d() -> np.ndarray:
  """int16 [TAB, TAB, 8, 8] 2d tap tables with exact-sum correction."""
  scale = 1.0 / INTER_TAB_SIZE
  tab1d = np.stack([_lanczos4_coeffs(i * scale)
                    for i in range(INTER_TAB_SIZE)])  # [TAB, 8] float
  out = np.empty((INTER_TAB_SIZE, INTER_TAB_SIZE, 8, 8), np.int32)
  for iy in range(INTER_TAB_SIZE):
    for ix in range(INTER_TAB_SIZE):
      prod = np.outer(tab1d[iy], tab1d[ix])
      itab = np.round(prod * COEF_SCALE).astype(np.int64)
      diff = int(COEF_SCALE - itab.sum())
      if diff != 0:
        # cv::initInterTab2D: push the residue onto the largest /
        # smallest entries, one unit at a time.
        order = np.argsort(itab, axis=None)
        idx = order[::-1] if diff > 0 else order
        for k in range(abs(diff)):
          flat = idx[k % len(idx)]
          itab.flat[flat] += 1 if diff > 0 else -1
      # saturate_cast<short>: the fraction-0 DC tap (exactly 2^15) and
      # corrected extremes clamp to the int16 range — benign for uint8
      # data thanks to the rounding shift, and what cv2 ships.
      out[iy, ix] = np.clip(itab, -32768, 32767).astype(np.int32)
  return out


def convert_maps(coords_x: np.ndarray, coords_y: np.ndarray):
  """cv::convertMaps (CV_32F pair -> CV_16SC2 + fraction indices).

  Returns (ix, iy) int16 integer coordinates and (fx, fy) uint8
  fraction indices in [0, 32).
  """
  sx = np.round(np.asarray(coords_x, np.float64) * INTER_TAB_SIZE)
  sy = np.round(np.asarray(coords_y, np.float64) * INTER_TAB_SIZE)
  sx = np.clip(sx, np.iinfo(np.int32).min, np.iinfo(np.int32).max)
  sy = np.clip(sy, np.iinfo(np.int32).min, np.iinfo(np.int32).max)
  sx = sx.astype(np.int64)
  sy = sy.astype(np.int64)
  ix = np.clip(sx >> INTER_BITS, -32768, 32767).astype(np.int16)
  iy = np.clip(sy >> INTER_BITS, -32768, 32767).astype(np.int16)
  fx = (sx & (INTER_TAB_SIZE - 1)).astype(np.uint8)
  fy = (sy & (INTER_TAB_SIZE - 1)).astype(np.uint8)
  return ix, iy, fx, fy


def remap_lanczos4(image: np.ndarray, coords_x: np.ndarray,
                   coords_y: np.ndarray, cval: float = 0.0) -> np.ndarray:
  """Fixed-point Lanczos4 remap of a 2d uint8/float image.

  out[p] = image sampled at (coords_y[p], coords_x[p]) through the
  quantized pipeline described in the module docstring. Out-of-range
  taps read `cval` (BORDER_CONSTANT). NaN coordinates produce `cval`.
  """
  image = np.asarray(image)
  float_in = image.dtype != np.uint8
  h, w = image.shape
  nan_mask = ~(np.isfinite(coords_x) & np.isfinite(coords_y))
  cx = np.where(nan_mask, -1e4, coords_x)
  cy = np.where(nan_mask, -1e4, coords_y)
  ix, iy, fx, fy = convert_maps(cx, cy)

  # Pad the image so every 8x8 tap window indexes in bounds; taps start
  # at (iy - 3, ix - 3).
  pad = 8
  padded = np.full((h + 2 * pad, w + 2 * pad), float(cval), np.float64)
  padded[pad:pad + h, pad:pad + w] = image
  base_y = np.clip(iy.astype(np.int64) - 3 + pad, 0,
                   h + 2 * pad - 8)
  oob_y = (iy < -pad + 3 - 8) | (iy > h + pad)
  base_x = np.clip(ix.astype(np.int64) - 3 + pad, 0, w + 2 * pad - 8)
  oob_x = (ix < -pad + 3 - 8) | (ix > w + pad)

  tabs = _tab2d()[fy.astype(np.int64), fx.astype(np.int64)]  # [..,8,8]
  acc = np.zeros(ix.shape, np.int64 if not float_in else np.float64)
  for ty in range(8):
    for tx in range(8):
      pix = padded[base_y + ty, base_x + tx]
      if float_in:
        acc = acc + tabs[..., ty, tx].astype(np.float64) * pix
      else:
        acc = acc + (tabs[..., ty, tx].astype(np.int64)
                     * np.round(pix).astype(np.int64))
  if float_in:
    out = acc / COEF_SCALE
  else:
    out = (acc + (1 << (COEF_BITS - 1))) >> COEF_BITS
    out = np.clip(out, 0, 255)
  out = np.where(nan_mask | oob_y | oob_x, cval, out)
  return out.astype(np.uint8 if not float_in else np.float32)
