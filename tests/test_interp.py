"""The gather sampler behind every render vs a NumPy float64 oracle."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from sofima_tpu import warp
from sofima_tpu.ops import interp
from sofima_tpu.utils import BoundingBox

METHODS = ['nearest', 'linear', 'cubic', 'lanczos']


def _taps(t, method):
  """Tap offsets (relative to the base index) and their weights."""
  if method == 'nearest':
    return [0], [np.ones_like(t)]
  if method == 'linear':
    return [0, 1], [1.0 - t, t]
  if method == 'cubic':
    a = -0.75  # Keys / OpenCV

    def near(d):
      return (a + 2.0) * d**3 - (a + 3.0) * d**2 + 1.0

    def far(d):
      return a * d**3 - 5.0 * a * d**2 + 8.0 * a * d - 4.0 * a

    return [-1, 0, 1, 2], [far(1.0 + t), near(t), near(1.0 - t),
                           far(2.0 - t)]
  ws = [np.sinc(t - i) * np.sinc((t - i) / 4.0) for i in range(-3, 5)]
  total = sum(ws)
  return list(range(-3, 5)), [w / total for w in ws]


def _oracle(image, coords, method, cval=0.0):
  """Separable resampling in float64: out-of-image taps read `cval`,
  zero-weight taps are inert, NaN coordinates give NaN."""
  image = np.asarray(image, np.float64)
  coords = np.asarray(coords, np.float64)
  nan = np.isnan(coords).any(axis=0)
  c = np.nan_to_num(coords)
  base = (np.round(c) if method == 'nearest' else np.floor(c)).astype(int)
  per_axis = [_taps(c[a] - base[a], method) for a in range(len(c))]
  out = np.zeros(c.shape[1:])
  for combo in itertools.product(*[range(len(p[0])) for p in per_axis]):
    idx, oob, w = [], np.zeros(c.shape[1:], bool), np.ones(c.shape[1:])
    for a, k in enumerate(combo):
      raw = base[a] + per_axis[a][0][k]
      oob |= (raw < 0) | (raw >= image.shape[a])
      idx.append(np.clip(raw, 0, image.shape[a] - 1))
      w = w * per_axis[a][1][k]
    val = np.where(oob, cval, image[tuple(idx)])
    with np.errstate(invalid='ignore'):
      out += np.where(w == 0.0, 0.0, w * val)
  return np.where(nan, np.nan, out)


def _image(shape, seed=0):
  return (np.random.RandomState(seed).rand(*shape) * 255).astype(np.float32)


def _assert_matches(got, ref, method):
  got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
  np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
  diff = np.abs(np.nan_to_num(got) - np.nan_to_num(ref))
  if method == 'nearest':
    # float32 coordinates may round the other way at exact half pixels.
    assert np.mean(diff > 1e-3) < 1e-3, np.mean(diff > 1e-3)
  else:
    assert diff.max() < 2e-2, diff.max()


class TestSample2d:

  @pytest.mark.parametrize('field', ['smooth', 'border'])
  @pytest.mark.parametrize('method', METHODS)
  def test_matches_oracle(self, method, field):
    img = _image((40, 52))
    yy, xx = np.mgrid[:36, :48].astype(np.float32)
    if field == 'smooth':
      coords = np.stack([yy + 2.3 + 1.7 * np.sin(xx / 5.0),
                         xx + 1.9 + 1.3 * np.cos(yy / 7.0)])
    else:
      # Samples running off every edge, plus invalid coordinates.
      coords = np.stack([yy * 1.25 - 4.6, xx * 1.2 - 5.3])
      coords[:, 10, 10:14] = np.nan
    coords = coords.astype(np.float32)
    got = interp.sample(jnp.asarray(img), jnp.asarray(coords),
                        method=method, mode='constant', cval=0.0)
    _assert_matches(got, _oracle(img, coords, method), method)


class TestSample3d:

  @pytest.mark.parametrize('method', ['nearest', 'linear', 'cubic'])
  def test_matches_oracle(self, method):
    vol = _image((12, 20, 24), seed=1)
    zz, yy, xx = np.mgrid[:12, :20, :24].astype(np.float32)
    coords = np.stack([zz + 0.6 * np.sin(yy / 4.0) - 0.3,
                       yy + 1.4 * np.cos(xx / 5.0) + 0.8,
                       xx - 1.1 + 0.9 * np.sin(zz / 3.0)]).astype(np.float32)
    got = interp.sample(jnp.asarray(vol), jnp.asarray(coords),
                        method=method, mode='constant', cval=0.0)
    _assert_matches(got, _oracle(vol, coords, method), method)


def _affine_offsets(shape_nodes, stride, coef):
  """Relative map (one channel per axis, xyz order) affine in position.

  Linear densification reproduces an affine field exactly, so the dense
  source coordinates are known in closed form: position + offset.
  """
  pos = np.mgrid[tuple(np.s_[:n] for n in shape_nodes)].astype(np.float64)
  pos = [p * s for p, s in zip(pos, stride)]  # zyx or yx pixel positions
  chans = []
  for c0, grads in coef:
    chans.append(c0 + sum(g * p for g, p in zip(grads, pos)))
  return np.stack(chans).astype(np.float32)


class TestWarpSubvolumeOracle:

  @pytest.mark.parametrize('method', METHODS)
  def test_affine_map(self, method):
    img = _image((64, 72), seed=2)
    s = 8.0
    rel = _affine_offsets((10, 10), (s, s),
                          [(2.3137, (0.03119, -0.05213)),
                           (-1.7071, (0.04429, 0.02713))])
    box = BoundingBox(start=(0, 0, 0), size=(72, 64, 1))
    mbox = BoundingBox(start=(0, 0, 0), size=(10, 10, 1))
    got = warp.warp_subvolume(img[None, None], box, rel[:, None], mbox, s,
                              box, interpolation=method)[0, 0]
    yy, xx = np.mgrid[:64, :72].astype(np.float64)
    coords = np.stack([yy + (-1.7071 + 0.04429 * yy + 0.02713 * xx),
                       xx + (2.3137 + 0.03119 * yy - 0.05213 * xx)])
    ref = np.nan_to_num(_oracle(img, coords.astype(np.float32), method))
    _assert_matches(got, ref, method)


class TestNdimageWarpOracle:

  @pytest.mark.parametrize('order', [0, 1, 3])
  def test_affine_map_3d(self, order):
    vol = _image((12, 24, 28), seed=3)
    stride = (4.0, 8.0, 8.0)
    # Coefficients off any short decimal grid: no exact half-pixel ties.
    coef = [(1.2173, (0.02137, 0.01529, -0.03071)),   # x offset
            (-0.8311, (-0.01093, 0.02517, 0.02039)),  # y offset
            (0.4129, (0.03113, -0.01237, 0.01061))]   # z offset
    rel = _affine_offsets((4, 4, 5), stride, coef)
    got = warp.ndimage_warp(vol, rel, stride=stride, work_size=(16, 16, 8),
                            overlap=(4, 4, 2), order=order)
    zz, yy, xx = np.mgrid[:12, :24, :28].astype(np.float64)

    def offset(c0, g):
      return c0 + g[0] * zz + g[1] * yy + g[2] * xx

    coords = np.stack([zz + offset(*coef[2]), yy + offset(*coef[1]),
                       xx + offset(*coef[0])]).astype(np.float32)
    method = {0: 'nearest', 1: 'linear', 3: 'cubic'}[order]
    ref = np.nan_to_num(_oracle(vol, coords, method, cval=np.nan))
    _assert_matches(got, ref, method)
