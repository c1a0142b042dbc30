"""Global registration primitives on device: phase correlation + ECC.

JAX replacements for the external registration routines the
reference calls in its affine decorators: skimage
`phase_cross_correlation` (/root/reference/decorators/affine.py:266-271)
and OpenCV `findTransformECC` (via opencv_utils,
/root/reference/decorators/affine.py:127-131).

* `phase_cross_correlation` — FFT cross-power-spectrum peak; returns the
  shift to apply to the moving image to align it to the reference.
* `estimate_affine_ecc` — Gauss-Newton maximization of the enhanced
  correlation coefficient over 2d affine (or translation/euclidean-
  restricted) warps: per-iteration bilinear warp + image-gradient
  Jacobian + 6x6 solve, all inside one `lax.fori_loop` device program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sofima_tpu.ops import interp


@functools.partial(jax.jit, static_argnames=['normalization', 'upsample'])
def _phase_corr(reference: jnp.ndarray, moving: jnp.ndarray,
                normalization: str | None = 'phase',
                upsample: int = 1) -> tuple[jnp.ndarray, jnp.ndarray]:
  shape = reference.shape
  f_ref = jnp.fft.rfftn(reference)
  f_mov = jnp.fft.rfftn(moving)
  cross = f_ref * jnp.conj(f_mov)
  if normalization == 'phase':
    cross = cross / jnp.maximum(jnp.abs(cross), 1e-12)
  corr = jnp.fft.irfftn(cross, s=shape)
  idx = jnp.argmax(corr)
  peak = corr.reshape(-1)[idx]
  shifts = jnp.stack(jnp.unravel_index(idx, shape)).astype(jnp.float32)
  dims = jnp.asarray(shape, jnp.float32)
  # Wrap shifts beyond the Nyquist point to negative offsets.
  shifts = jnp.where(shifts > dims // 2, shifts - dims, shifts)
  return shifts, peak


def phase_cross_correlation(reference_image: np.ndarray,
                            moving_image: np.ndarray,
                            normalization: str | None = 'phase',
                            upsample_factor: int = 1,
                            **unused_kwargs):
  """skimage-compatible: returns (shift, error, phasediff).

  `shift` (per axis, image order) is the translation to apply to
  `moving_image` so it aligns with `reference_image`.
  """
  shifts, peak = _phase_corr(
      jnp.asarray(reference_image, jnp.float32),
      jnp.asarray(moving_image, jnp.float32),
      normalization=normalization)
  return np.asarray(shifts), float(1.0 - peak), 0.0


_MOTION_PARAMS = {'translation': 2, 'euclidean': 3, 'affine': 6}


@functools.partial(jax.jit, static_argnames=['num_iters', 'motion'])
def _ecc_core(fixed: jnp.ndarray, moving: jnp.ndarray,
              init_matrix: jnp.ndarray, num_iters: int,
              motion: str) -> jnp.ndarray:
  """Gauss-Newton ECC; returns the 2x3 warp matrix (xy convention).

  The matrix maps homogeneous moving-image coords to fixed-image coords:
  sampling the moving image at W^-1(fixed grid) reconstructs `fixed`.
  """
  h, w = fixed.shape
  yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                        jnp.arange(w, dtype=jnp.float32), indexing='ij')

  def normalize(img):
    return (img - jnp.mean(img)) / (jnp.std(img) + 1e-8)

  f = normalize(fixed)
  mov_n = normalize(moving)

  def gradients(img):
    gy = jnp.gradient(img, axis=0)
    gx = jnp.gradient(img, axis=1)
    return gx, gy

  def body(_, params):
    # params: [6] = flattened 2x3 (a, b, tx, c, d, ty), xy convention:
    # x' = a x + b y + tx ;  y' = c x + d y + ty
    a, b, tx, c, d, ty = params
    sx = a * xx + b * yy + tx
    sy = c * xx + d * yy + ty
    warped = interp.sample(mov_n, jnp.stack([sy, sx]), method='linear',
                           mode='nearest')
    gx, gy = gradients(warped)
    r = f - warped

    j_cols = [gx * xx, gx * yy, gx, gy * xx, gy * yy, gy]
    jmat = jnp.stack([col.ravel() for col in j_cols], axis=1)  # [n, 6]

    if motion == 'translation':
      mask = jnp.asarray([0, 0, 1, 0, 0, 1], jnp.float32)
    else:
      mask = jnp.ones(6, jnp.float32)
    jmat = jmat * mask[None]

    jtj = jmat.T @ jmat + 1e-6 * jnp.eye(6)
    jtr = jmat.T @ r.ravel()
    # Forward-additive Gauss-Newton: warped(p+δ) ≈ warped + Jδ, so the
    # normal-equation step is added to the parameters.
    delta = jnp.linalg.solve(jtj, jtr)
    params = params + delta

    if motion == 'euclidean':
      # Project back onto rotations: nearest orthogonal 2x2.
      a2, b2, tx2, c2, d2, ty2 = params
      mat = jnp.array([[a2, b2], [c2, d2]])
      u, _, vt = jnp.linalg.svd(mat)
      rot = u @ vt
      params = jnp.array([rot[0, 0], rot[0, 1], tx2,
                          rot[1, 0], rot[1, 1], ty2])
    return params

  init = jnp.array([init_matrix[0, 0], init_matrix[0, 1], init_matrix[0, 2],
                    init_matrix[1, 0], init_matrix[1, 1],
                    init_matrix[1, 2]], jnp.float32)
  params = jax.lax.fori_loop(0, num_iters, body, init)
  a, b, tx, c, d, ty = params
  return jnp.array([[a, b, tx], [c, d, ty]])


def optim_transform(fix: np.ndarray, mov: np.ndarray,
                    transform_initial: np.ndarray | None = None,
                    num_iters: int = 100, motion: str = 'affine',
                    **unused_kwargs) -> tuple[float, np.ndarray]:
  """ECC alignment of 2d images (xy convention, like opencv_utils).

  Args:
    fix: fixed image ([x, y] axis order, following the OpenCV-style
      convention of the reference decorator layer)
    mov: moving image
    transform_initial: optional 2x3 init (identity otherwise)
    num_iters: Gauss-Newton iterations
    motion: 'translation' | 'euclidean' | 'affine'

  Returns:
    (final correlation coefficient, [2, 3] transform) such that warping
    `mov` by the inverse transform aligns it to `fix`.
  """
  if motion not in _MOTION_PARAMS:
    raise ValueError(f'unknown motion model {motion!r}')
  if transform_initial is None:
    transform_initial = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
  # Work in [y, x] internally; the xy convention transposes the images.
  matrix = _ecc_core(jnp.asarray(fix.T, jnp.float32),
                     jnp.asarray(mov.T, jnp.float32),
                     jnp.asarray(transform_initial, jnp.float32),
                     num_iters, motion)
  matrix = np.asarray(matrix, np.float64)

  # Final quality: correlation coefficient of the aligned pair.
  h, w = fix.T.shape
  yy, xx = np.mgrid[:h, :w].astype(np.float32)
  sx = matrix[0, 0] * xx + matrix[0, 1] * yy + matrix[0, 2]
  sy = matrix[1, 0] * xx + matrix[1, 1] * yy + matrix[1, 2]
  warped = np.asarray(interp.sample(
      jnp.asarray(mov.T, jnp.float32),
      jnp.asarray(np.stack([sy, sx])), method='linear', mode='nearest'))
  fz = fix.T - fix.T.mean()
  wz = warped - warped.mean()
  cc = float((fz * wz).sum()
             / (np.linalg.norm(fz) * np.linalg.norm(wz) + 1e-8))
  return cc, matrix
