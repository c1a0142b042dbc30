"""Device render phases (stack, montage, 3d stitch) vs the gather sampler."""

import jax.numpy as jnp
import numpy as np
import pytest

from sofima_tpu.ops import interp
from sofima_tpu.pipeline import montage, stack_align, stitch3d

METHODS = ['nearest', 'linear', 'cubic', 'lanczos']


def _texture(shape, seed=0):
  rng = np.random.RandomState(seed)
  f = np.fft.rfftn(rng.rand(*shape))
  freqs = np.meshgrid(*[np.fft.fftfreq(n) for n in shape[:-1]],
                      np.fft.rfftfreq(shape[-1]), indexing='ij')
  f *= np.exp(-sum(q**2 for q in freqs) / (2 * 0.1**2))
  img = np.fft.irfftn(f, s=shape, axes=tuple(range(len(shape))))
  return ((img - img.min()) / np.ptp(img) * 255.0).astype(np.float32)


def _assert_close(got, ref):
  # Densification differs from the reference's bilinear grid sampling
  # by float32 rounding of the coordinates (~1e-5 px); 'nearest' can
  # flip at exact half-pixel ties, so bound the share of pixels off.
  diff = np.abs(np.asarray(got) - np.asarray(ref))
  assert np.mean(diff > 1e-2) < 1e-3, np.mean(diff > 1e-2)
  assert np.mean(diff) < 1e-2, np.mean(diff)


class TestStackRender:

  @pytest.mark.parametrize('n', [512, 360])
  @pytest.mark.parametrize('method', METHODS)
  def test_matches_gather(self, method, n):
    s = 40
    g = n // s
    my, mx = np.mgrid[:g, :g].astype(np.float32)
    rel = np.stack([3.3 + 2.0 * np.sin(my / 3.0),
                    -2.7 + 1.5 * np.cos(mx / 4.0)]).astype(np.float32)
    node = np.arange(g, dtype=np.float32) * s
    query = np.stack([np.broadcast_to(node[None, :], (g, g)),
                      np.broadcast_to(node[:, None], (g, g))])
    inv_abs = rel + query
    sec = _texture((n, n))
    cfg = stack_align.StackAlignConfig(method=method)
    got, overflow = stack_align._render_phase(
        jnp.asarray(sec), jnp.asarray(rel), jnp.asarray(inv_abs), cfg)
    yy, xx = np.mgrid[:n, :n].astype(np.float32) / s
    grid = jnp.asarray(np.stack([yy, xx]))
    coords = jnp.stack([
        interp.grid_sample_linear(jnp.asarray(inv_abs[1]), grid),
        interp.grid_sample_linear(jnp.asarray(inv_abs[0]), grid)])
    ref = interp.sample(jnp.asarray(sec), coords, method=method,
                        mode='constant', cval=0.0)
    assert got.shape == (n, n)
    _assert_close(got, ref)
    assert not bool(overflow)


class TestMontageRender:

  @pytest.mark.parametrize('tile_shape', [(256, 512), (200, 330)])
  @pytest.mark.parametrize('method', METHODS)
  def test_translated_tile_matches_gather(self, method, tile_shape):
    s, pad = 40, 2
    ty, tx = tile_shape
    gy, gx = ty // s + 1, tx // s + 1
    shift_xy = (2.25, -1.3)
    resid = np.zeros((2, gy, gx), np.float32)
    resid[0], resid[1] = shift_xy
    tile = _texture(tile_shape, seed=1)
    warped, mask, overflow = montage._render_tile_device(
        jnp.asarray(tile), jnp.asarray(resid), s, 8, pad, 4, 8, method,
        16, 4)
    oy, ox = warped.shape
    assert (oy, ox) == ((gy + 2 * pad) * s, (gx + 2 * pad) * s)
    # Output pixel (0, 0) sits at tile pixel (-pad, -pad); the forward
    # map moves content by +shift, so output q samples q - shift.
    yy, xx = np.mgrid[:oy, :ox].astype(np.float32) - pad * s
    coords = jnp.asarray(np.stack([yy - shift_xy[1], xx - shift_xy[0]]))
    ref = interp.sample(jnp.asarray(tile), coords, method=method,
                        mode='constant', cval=0.0)
    _assert_close(warped, ref)
    assert np.asarray(mask).any() and not bool(overflow)


class TestStitch3dRender:

  @pytest.mark.parametrize('tile_shape', [(16, 32, 48), (15, 37, 41)])
  def test_translated_tile_matches_trilinear_gather(self, tile_shape):
    stride, pad = (8, 8, 8), 1
    tz, ty, tx = tile_shape
    g = tuple(n // st + 1 for n, st in zip(tile_shape, stride))
    shift_xyz = (1.25, -0.5, 0.75)
    resid = np.zeros((3,) + g, np.float32)
    for c in range(3):
      resid[c] = shift_xyz[c]
    tile = _texture(tile_shape, seed=2)
    edges = jnp.asarray([-1.0, ty, -1.0, tx], jnp.float32)
    warped, weights = stitch3d._render_tile_3d(
        jnp.asarray(tile), edges, jnp.asarray(resid), stride, pad, 16, 4)
    out_shape = tuple((n + 2 * pad) * st for n, st in zip(g, stride))
    assert warped.shape == weights.shape == out_shape
    zz, yy, xx = np.mgrid[tuple(np.s_[:n] for n in out_shape)].astype(
        np.float32) - pad * stride[0]
    coords = jnp.asarray(np.stack([zz - shift_xyz[2], yy - shift_xyz[1],
                                   xx - shift_xyz[0]]))
    ref = interp.sample(jnp.asarray(tile), coords, method='linear',
                        mode='constant', cval=0.0)
    _assert_close(warped, ref)
    assert float(jnp.max(weights)) > 0
