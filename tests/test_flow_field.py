"""Tests for the flow estimator (impulse/analytic test vectors)."""

import numpy as np
import pytest

from sofima_tpu import flow_field


class TestNextFastLen:

  def test_values(self):
    assert flow_field.next_fast_len(1) == 1
    assert flow_field.next_fast_len(7) == 8
    assert flow_field.next_fast_len(9) == 9
    assert flow_field.next_fast_len(159) == 160
    assert flow_field.next_fast_len(319) == 320
    assert flow_field.next_fast_len(321) == 324

  def test_is_smooth(self):
    for n in range(1, 300):
      m = flow_field.next_fast_len(n)
      assert m >= n
      k = m
      for p in (2, 3, 5):
        while k % p == 0:
          k //= p
      assert k == 1, (n, m)


class TestMaskedXcorr:

  def test_unmasked_impulse(self):
    prev = np.zeros((16, 16), np.float32)
    curr = np.zeros((16, 16), np.float32)
    prev[8, 8] = 1.0
    curr[10, 5] = 1.0
    xc = np.asarray(flow_field.masked_xcorr(prev, curr, dim=2))
    assert xc.shape == (31, 31)
    peak = np.unravel_index(np.argmax(xc), xc.shape)
    center = (15, 15)
    # Peak offset = pre - post position.
    assert peak[0] - center[0] == 8 - 10
    assert peak[1] - center[1] == 8 - 5

  def test_masked_decoy_excluded(self):
    rng = np.random.RandomState(0)
    base = rng.rand(24, 24).astype(np.float32)
    prev = base
    curr = np.roll(base, (2, -3), axis=(0, 1))
    # Corrupt a corner of curr; mask it out.
    curr = curr.copy()
    curr[:8, :8] = rng.rand(8, 8)
    curr_mask = np.zeros((24, 24), bool)
    curr_mask[:8, :8] = True
    xc = np.asarray(
        flow_field.masked_xcorr(prev - prev.mean(), curr - curr.mean(),
                                curr_mask=curr_mask, dim=2))
    peak = np.unravel_index(np.nanargmax(xc), xc.shape)
    assert (peak[0] - 23, peak[1] - 23) == (-2, 3)
    # Normalized output bounded.
    assert np.nanmax(xc) <= 1.0 + 1e-5

  def test_batched(self):
    prev = np.zeros((3, 12, 12), np.float32)
    curr = np.zeros((3, 12, 12), np.float32)
    for b, (dy, dx) in enumerate([(0, 0), (2, 1), (-3, 2)]):
      prev[b, 6, 6] = 1.0
      curr[b, 6 + dy, 6 + dx] = 1.0
    xc = np.asarray(flow_field.masked_xcorr(prev, curr, dim=2))
    assert xc.shape == (3, 23, 23)
    for b, (dy, dx) in enumerate([(0, 0), (2, 1), (-3, 2)]):
      peak = np.unravel_index(np.argmax(xc[b]), xc[b].shape)
      assert (peak[0] - 11, peak[1] - 11) == (-dy, -dx)


class TestBatchedPeaks:

  def test_analytic_gaussian(self):
    hy, hx = np.mgrid[:50, :50]
    cy, cx = 20, 28
    r = np.sqrt(2.0 * (cx - hx) ** 2 + (cy - hy) ** 2)
    xcorr = 10.0 * np.exp(-r / 4)
    peaks = np.asarray(
        flow_field._batched_peaks(
            xcorr[np.newaxis].astype(np.float32), (25, 25),
            min_distance=2, threshold_rel=0.5, peak_radius=(2, 3)))
    assert peaks.shape == (1, 4)
    support = np.min(xcorr[cy - 2:cy + 3, cx - 3:cx + 4])
    assert peaks[0, 0] == 3  # x
    assert peaks[0, 1] == -5  # y
    np.testing.assert_allclose(peaks[0, 2], 10.0 / support, rtol=1e-5)
    assert peaks[0, 3] == 0  # single peak -> ratio 0

  def test_two_peaks_ratio(self):
    img = np.zeros((1, 30, 30), np.float32)
    img[0, 10, 10] = 1.0
    img[0, 20, 22] = 0.8
    peaks = np.asarray(
        flow_field._batched_peaks(img, (15, 15), min_distance=2,
                                  threshold_rel=0.5, peak_radius=2))
    np.testing.assert_allclose(peaks[0, 3], 1.0 / 0.8, rtol=1e-5)
    assert peaks[0, 0] == -5 and peaks[0, 1] == -5

  def test_no_peak_nan(self):
    img = np.zeros((1, 20, 20), np.float32)
    peaks = np.asarray(
        flow_field._batched_peaks(img, (10, 10), min_distance=2,
                                  threshold_rel=0.5, peak_radius=2))
    assert np.isnan(peaks).all()


class TestFlowField:

  def test_impulse_2d(self):
    pre = np.zeros((120, 120), np.uint8)
    post = np.zeros((120, 120), np.uint8)
    pre[60, 60] = 255
    post[70, 53] = 255

    mfc = flow_field.JAXMaskedXCorrWithStatsCalculator()
    field = mfc.flow_field(pre, post, patch_size=80, step=40, batch_size=4)
    assert field.shape == (4, 2, 2)
    np.testing.assert_array_equal(field[0], 7.0)   # x: 60 - 53
    np.testing.assert_array_equal(field[1], -10.0)  # y: 60 - 70
    np.testing.assert_array_equal(field[3], 0.0)   # single peak

  def test_impulse_2d_with_decoy_mask(self):
    pre = np.zeros((120, 120), np.uint8)
    post = np.zeros((120, 120), np.uint8)
    pre[60, 60] = 255
    post[70, 53] = 255
    post[54, 68] = 255  # decoy
    post_mask = np.zeros((120, 120), bool)
    post_mask[:55, :70] = True  # mask covers the decoy

    mfc = flow_field.JAXMaskedXCorrWithStatsCalculator()
    field = mfc.flow_field(pre, post, patch_size=80, step=40,
                           post_mask=post_mask, batch_size=4)
    np.testing.assert_array_equal(field[0], 7.0)
    np.testing.assert_array_equal(field[1], -10.0)

  def test_impulse_3d(self):
    pre = np.zeros((50, 100, 100), np.uint8)
    post = np.zeros((50, 100, 100), np.uint8)
    pre[25, 50, 50] = 255
    post[22, 45, 54] = 255

    mfc = flow_field.JAXMaskedXCorrWithStatsCalculator()
    field = mfc.flow_field(pre, post, patch_size=(40, 80, 80), step=10,
                           batch_size=2)
    assert field.shape == (5, 2, 3, 3)
    np.testing.assert_array_equal(field[0], -4.0)  # x: 50 - 54
    np.testing.assert_array_equal(field[1], 5.0)   # y: 50 - 45
    np.testing.assert_array_equal(field[2], 3.0)   # z: 25 - 22

  def test_selection_mask(self):
    pre = np.zeros((120, 120), np.uint8)
    post = np.zeros((120, 120), np.uint8)
    pre[60, 60] = 255
    post[62, 57] = 255
    sel = np.zeros((2, 2), bool)
    sel[0, 1] = True
    mfc = flow_field.JAXMaskedXCorrWithStatsCalculator()
    field = mfc.flow_field(pre, post, patch_size=80, step=40, batch_size=4,
                           selection_mask=sel)
    assert np.isfinite(field[:, 0, 1]).all()
    assert np.isnan(field[:, 0, 0]).all()
    assert np.isnan(field[:, 1, 1]).all()

  def test_mask_occupancy_deselects(self):
    pre = np.random.RandomState(0).rand(120, 120).astype(np.float32)
    post = pre.copy()
    pre_mask = np.zeros((120, 120), bool)
    pre_mask[:, :80] = True  # left patches >75% masked
    mfc = flow_field.JAXMaskedXCorrWithStatsCalculator()
    field = mfc.flow_field(pre, post, patch_size=80, step=40,
                           pre_mask=pre_mask,
                           mask_only_for_patch_selection=True, batch_size=4)
    assert np.isnan(field[:, :, 0]).all()  # fully masked column deselected
    assert np.isfinite(field[0, 0, 1])

  def test_post_targeting_extends_range(self):
    pre = np.zeros((120, 120), np.uint8)
    post = np.zeros((120, 120), np.uint8)
    pre[50, 55] = 255
    post[100, 100] = 255

    mfc = flow_field.JAXMaskedXCorrWithStatsCalculator()
    field = mfc.flow_field(pre, post, patch_size=80, step=40, batch_size=4)
    assert np.isnan(field[:, 0, 0]).all()

    tgt = np.full((2, 2, 2), 40.0, dtype=np.float32)
    field = mfc.flow_field(pre, post, patch_size=80, step=40, batch_size=4,
                           post_targeting_field=tgt, post_targeting_step=40)
    np.testing.assert_array_equal(field[0], -45.0)
    np.testing.assert_array_equal(field[1], -50.0)

  def test_identical_images_zero_flow(self):
    img = np.random.RandomState(1).rand(160, 160).astype(np.float32)
    mfc = flow_field.JAXMaskedXCorrWithStatsCalculator()
    field = mfc.flow_field(img, img, patch_size=60, step=20, batch_size=8)
    valid = np.isfinite(field[0])
    assert valid.any()
    np.testing.assert_array_equal(field[0][valid], 0.0)
    np.testing.assert_array_equal(field[1][valid], 0.0)


class TestCircularMode:

  def test_agrees_with_linear_correlation(self):
    rng = np.random.RandomState(0)
    noise = rng.rand(512, 512).astype(np.float32)
    f2 = np.fft.rfft2(noise)
    fy = np.fft.fftfreq(512)[:, None]
    fx = np.fft.rfftfreq(512)[None, :]
    f2 *= np.exp(-((fx**2 + fy**2) / (2 * 0.08**2)))
    tex = (np.fft.irfft2(f2, s=(512, 512)) * 1000).astype(np.float32)
    post = np.roll(tex, (7, -12), (0, 1))
    import jax.numpy as jnp
    ref = np.asarray(flow_field.dense_flow_field(
        jnp.asarray(tex), jnp.asarray(post), (160, 160), (40, 40),
        batch_size=16))
    circ = np.asarray(flow_field.dense_flow_field(
        jnp.asarray(tex), jnp.asarray(post), (160, 160), (40, 40),
        batch_size=16, circular=True))
    assert np.mean((ref[0] == circ[0]) & (ref[1] == circ[1])) > 0.98

  def test_impulse(self):
    import jax.numpy as jnp
    pre = np.zeros((120, 120), np.float32)
    post = np.zeros((120, 120), np.float32)
    pre[60, 60] = 255
    post[70, 53] = 255
    c = np.asarray(flow_field.dense_flow_field(
        jnp.asarray(pre), jnp.asarray(post), (80, 80), (40, 40),
        batch_size=4, circular=True))
    np.testing.assert_array_equal(c[0], 7.0)
    np.testing.assert_array_equal(c[1], -10.0)


class TestCircularMaskedMode:

  def test_masked_circular_matches_padfield_peaks(self):
    # Decoy feature excluded by mask: both backends must find the true
    # shift.
    pre = np.zeros((120, 120), np.uint8)
    post = np.zeros((120, 120), np.uint8)
    pre[60, 60] = 255
    post[70, 53] = 255
    post[54, 68] = 255  # decoy
    post_mask = np.zeros((120, 120), bool)
    post_mask[:55, :70] = True

    mfc = flow_field.JAXMaskedXCorrWithStatsCalculator()
    ref = mfc.flow_field(pre, post, patch_size=80, step=40,
                         post_mask=post_mask, batch_size=4)
    fast = mfc.flow_field(pre, post, patch_size=80, step=40,
                          post_mask=post_mask, batch_size=4,
                          mode='circular')
    np.testing.assert_array_equal(fast[0], ref[0])
    np.testing.assert_array_equal(fast[1], ref[1])

  def test_mask_only_for_patch_selection_fast(self):
    pre = np.random.RandomState(0).rand(120, 120).astype(np.float32)
    post = pre.copy()
    pre_mask = np.zeros((120, 120), bool)
    pre_mask[:, :80] = True
    mfc = flow_field.JAXMaskedXCorrWithStatsCalculator()
    fast = mfc.flow_field(pre, post, patch_size=80, step=40,
                          pre_mask=pre_mask,
                          mask_only_for_patch_selection=True, batch_size=4,
                          mode='circular_dft')
    assert np.isnan(fast[:, :, 0]).all()
    assert np.isfinite(fast[0, 0, 1])
    np.testing.assert_array_equal(fast[0][np.isfinite(fast[0])], 0.0)

  def test_selection_mask_fast(self):
    pre = np.zeros((120, 120), np.uint8)
    post = np.zeros((120, 120), np.uint8)
    pre[60, 60] = 255
    post[62, 57] = 255
    sel = np.zeros((2, 2), bool)
    sel[0, 1] = True
    mfc = flow_field.JAXMaskedXCorrWithStatsCalculator()
    fast = mfc.flow_field(pre, post, patch_size=80, step=40, batch_size=4,
                          selection_mask=sel, mode='circular')
    assert np.isfinite(fast[:2, 0, 1]).all()
    assert np.isnan(fast[:, 0, 0]).all()


class TestStripPath:
  """The gather-free strip-sliced dense path (production hot kernel)."""

  def _tex(self, n, seed=0):
    rng = np.random.RandomState(seed)
    noise = rng.rand(n, n).astype(np.float32)
    f2 = np.fft.rfft2(noise)
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.rfftfreq(n)[None, :]
    f2 *= np.exp(-((fx**2 + fy**2) / (2 * 0.08**2)))
    return (np.fft.irfft2(f2, s=(n, n)) * 1000).astype(np.float32)

  def test_strip_patches_equals_gather(self):
    import jax.numpy as jnp
    rng = np.random.RandomState(1)
    img = rng.rand(200, 280).astype(np.float32)
    patch, step = (80, 80), (40, 40)
    rows, gx = 3, 6
    strip = img[:(rows - 1) * 40 + 80, :(gx - 1) * 40 + 80]
    got = np.asarray(flow_field._strip_patches(
        jnp.asarray(strip), rows, gx, patch, step))
    for r in range(rows):
      for j in range(gx):
        expect = img[r * 40:r * 40 + 80, j * 40:j * 40 + 80]
        np.testing.assert_array_equal(got[r * gx + j], expect)

  def test_odd_grid_rows_with_clamped_last_strip(self):
    # gy odd and rows_per_step > 1: the last strip is clamped and its
    # duplicated rows must land at the correct grid positions.
    import jax.numpy as jnp
    tex = self._tex(280, seed=2)
    post = np.roll(tex, (5, -3), (0, 1))
    # grid is (6, 6) at patch 80 / step 40; batch_size 12 -> 2 rows/strip.
    out = np.asarray(flow_field.dense_flow_field(
        jnp.asarray(tex[:260]), jnp.asarray(post[:260]), (80, 80), (40, 40),
        batch_size=12, circular=True, dft_matmul=True))
    assert out.shape[1] == 5  # odd row count
    valid = np.isfinite(out[0])
    assert valid.mean() > 0.9
    np.testing.assert_array_equal(out[0][valid], 3.0)
    np.testing.assert_array_equal(out[1][valid], -5.0)

  def test_bf16_integer_peak_parity(self):
    import jax.numpy as jnp
    tex = self._tex(512, seed=3)
    post = np.roll(tex, (7, -12), (0, 1))
    f32 = np.asarray(flow_field.dense_flow_field(
        jnp.asarray(tex), jnp.asarray(post), (160, 160), (40, 40),
        batch_size=512, circular=True, dft_matmul=True))
    b16 = np.asarray(flow_field.dense_flow_field(
        jnp.asarray(tex), jnp.asarray(post), (160, 160), (40, 40),
        batch_size=512, circular=True, dft_matmul=True, bf16=True))
    v = np.isfinite(f32[0]) & np.isfinite(b16[0])
    agree = np.mean((f32[0][v] == b16[0][v]) & (f32[1][v] == b16[1][v]))
    assert agree > 0.99, agree
    assert np.nanmedian(b16[0]) == np.nanmedian(f32[0])
    assert np.nanmedian(b16[1]) == np.nanmedian(f32[1])

  def test_strip_masked_matches_start_path(self):
    # Masked circular NCC through strips must match the calculator's
    # padfield reference on a decoy-masked impulse (same contract as
    # TestCircularMaskedMode but with a grid wide enough to use strips).
    pre = np.zeros((200, 200), np.uint8)
    post = np.zeros((200, 200), np.uint8)
    pre[100, 100] = 255
    post[110, 93] = 255
    post[94, 108] = 255  # decoy
    post_mask = np.zeros((200, 200), bool)
    post_mask[:95, :110] = True
    mfc = flow_field.JAXMaskedXCorrWithStatsCalculator()
    ref = mfc.flow_field(pre, post, patch_size=80, step=40,
                         post_mask=post_mask, batch_size=4)
    fast = mfc.flow_field(pre, post, patch_size=80, step=40,
                          post_mask=post_mask, batch_size=4,
                          mode='circular')
    np.testing.assert_array_equal(fast[0], ref[0])
    np.testing.assert_array_equal(fast[1], ref[1])

  def test_strip_masked_3d_matches_padfield(self):
    # Dim-generic masked circular NCC (the 3d LICONN production regime,
    # previously a NotImplementedError cliff onto the padfield path):
    # strip path peaks must match the masked padfield oracle on a
    # decoy-masked 3d impulse.
    import jax.numpy as jnp
    rng = np.random.RandomState(5)
    pre = (rng.rand(24, 96, 96) * 50).astype(np.float32)
    post = np.roll(pre, (2, -3, 4), (0, 1, 2))
    pre[12, 48, 48] += 200.0
    post[14, 45, 52] += 200.0
    post[8, 60, 40] += 500.0  # decoy, masked out below
    post_mask = np.zeros(post.shape, bool)
    post_mask[4:12, 52:68, 32:48] = True
    patch, step = (16, 32, 32), (8, 16, 16)
    mfc = flow_field.JAXMaskedXCorrWithStatsCalculator()
    ref = mfc.flow_field(pre, post, patch_size=patch, step=step,
                         post_mask=post_mask, batch_size=16)
    fast = np.asarray(flow_field.dense_flow_field(
        jnp.asarray(pre), jnp.asarray(post), patch, step,
        circular=True, post_mask=jnp.asarray(post_mask)))
    v = np.isfinite(ref[0]) & np.isfinite(fast[0])
    assert v.mean() > 0.9, v.mean()
    agree = np.mean([(fast[c][v] == ref[c][v]).mean() for c in range(3)])
    assert agree > 0.98, agree

  def test_masked_3d_start_path_no_raise(self):
    # Non-strip 3d geometries (patch not a multiple of step) route
    # through the batched circular path, which now handles masks for
    # any rank instead of raising.
    import jax.numpy as jnp
    rng = np.random.RandomState(6)
    pre = (rng.rand(20, 60, 60) * 50).astype(np.float32)
    post = np.roll(pre, (1, -2, 3), (0, 1, 2))
    mask = np.zeros(pre.shape, bool)
    mask[:, :10] = True
    out = np.asarray(flow_field.dense_flow_field(
        jnp.asarray(pre), jnp.asarray(post), (12, 36, 36), (8, 24, 24),
        circular=True, pre_mask=jnp.asarray(mask),
        post_mask=jnp.asarray(mask)))
    v = np.isfinite(out[0])
    assert v.any()
    # flow = position in pre minus position in post = -(roll amount)
    assert np.nanmedian(out[0]) == -3.0  # x
    assert np.nanmedian(out[1]) == 2.0   # y
    assert np.nanmedian(out[2]) == -1.0  # z


class TestDenseFlow3d:
  """Round-3: device-resident circular 3d strip path."""

  def _vol(self, d=60, h=280, w=160, seed=0):
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    vol = gaussian_filter(rng.rand(d, h, w).astype(np.float32), 1.5)
    return ((vol - vol.min()) / np.ptp(vol) * 255).astype(np.float32)

  def test_matches_padfield_integer_peaks(self):
    import jax.numpy as jnp
    vol = self._vol()
    post = np.roll(vol, (2, -3, 4), (0, 1, 2))
    patch, step = (40, 80, 80), (20, 40, 40)
    circ = np.asarray(flow_field.dense_flow_field(
        jnp.asarray(vol), jnp.asarray(post), patch, step, circular=True))
    mfc = flow_field.JAXMaskedXCorrWithStatsCalculator()
    ref = mfc.flow_field(vol, post, patch_size=patch, step=step,
                         batch_size=16)
    assert circ.shape == ref.shape
    for c in range(3):
      np.testing.assert_array_equal(
          np.nan_to_num(circ[c], nan=9e9), np.nan_to_num(ref[c], nan=9e9))

  def test_known_shift_recovered(self):
    import jax.numpy as jnp
    vol = self._vol(48, 200, 200, seed=1)
    post = np.roll(vol, (-1, 5, -6), (0, 1, 2))
    out = np.asarray(flow_field.dense_flow_field(
        jnp.asarray(vol), jnp.asarray(post), (40, 80, 80), (8, 40, 40),
        circular=True))
    assert float(np.nanmedian(out[0])) == 6.0   # x
    assert float(np.nanmedian(out[1])) == -5.0  # y
    assert float(np.nanmedian(out[2])) == 1.0   # z


def _band_limited(h, w, seed):
  rng = np.random.RandomState(seed)
  f = np.fft.rfft2(rng.rand(h, w).astype(np.float32))
  fy = np.fft.fftfreq(h)[:, None]
  fx = np.fft.rfftfreq(w)[None, :]
  f *= np.exp(-((fx**2 + fy**2) / (2 * 0.08**2)))
  img = np.fft.irfft2(f, s=(h, w)).astype(np.float32)
  return (img - img.min()) / np.ptp(img) * 255.0


class TestTargetedFlowPeaks:
  """XLA targeted fine pass (per-node integer post offsets)."""

  SHIFT = (5, -7)  # (y, x) roll of post relative to pre

  def _pair(self):
    pre = _band_limited(400, 440, seed=4)
    return pre, np.roll(pre, self.SHIFT, (0, 1))

  def _offsets(self, kind, grid):
    flow_yx = -np.asarray(self.SHIFT)
    if kind == 'zero':
      return np.zeros(grid + (2,), np.int32)
    if kind == 'uniform':
      return np.broadcast_to(-flow_yx, grid + (2,)).astype(np.int32)
    rng = np.random.RandomState(0)
    return (-flow_yx + rng.randint(-3, 4, grid + (2,))).astype(np.int32)

  @pytest.mark.parametrize('fine', [64, 80])
  @pytest.mark.parametrize('peak_crop', [None, 32])
  @pytest.mark.parametrize('kind', ['zero', 'uniform', 'per_node'])
  def test_matches_dense_flow_field(self, kind, peak_crop, fine):
    import jax.numpy as jnp
    pre, post = self._pair()
    step = (40, 40)
    ref = np.asarray(flow_field.dense_flow_field(
        jnp.asarray(pre), jnp.asarray(post), (fine, fine), step,
        circular=True, dft_matmul=True))
    grid = ref.shape[1:]
    offs = self._offsets(kind, grid)
    got = np.asarray(flow_field.targeted_flow_peaks(
        jnp.asarray(pre), jnp.asarray(post), jnp.asarray(offs),
        (fine, fine), step, max_offset=16, peak_crop=peak_crop))
    assert got.shape == ref.shape
    # Absolute flow = peak relative to the shifted patch - the offset.
    got_abs = np.stack([got[0] - offs[..., 1], got[1] - offs[..., 0]])
    inner = np.s_[:, 1:-1, 1:-1]
    np.testing.assert_array_equal(got_abs[inner], ref[:2][inner])
    flow_xy = (-self.SHIFT[1], -self.SHIFT[0])
    assert (got_abs[0][inner[1:]] == flow_xy[0]).all()
    assert (got_abs[1][inner[1:]] == flow_xy[1]).all()
    if kind == 'zero' and peak_crop is None:
      # Same patches, same arithmetic: the statistics agree too.
      np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

  @pytest.mark.parametrize('name,peak_crop,bf16', [
      ('full_f32', None, False), ('crop32_bf16', 32, True)])
  def test_matches_golden(self, name, peak_crop, bf16):
    # Recorded from the former grouped-window kernel with offsets that
    # are constant within each of its windows; the twin gets the same
    # offsets expanded to every node, so the integer peaks must agree
    # exactly.
    import os
    import jax.numpy as jnp
    golden = np.load(os.path.join(os.path.dirname(__file__), 'golden',
                                  'targeted_flow_peaks.npz'))
    ref = golden[name]
    got = np.asarray(flow_field.targeted_flow_peaks(
        jnp.asarray(golden['pre'], jnp.float32),
        jnp.asarray(golden['post'], jnp.float32),
        jnp.asarray(golden['offsets']), (80, 80), (40, 40), max_offset=8,
        bf16=bf16, peak_crop=peak_crop))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[:2], ref[:2])
    np.testing.assert_array_equal(np.isnan(got[2:]), np.isnan(ref[2:]))
    sharp = np.abs(got[2] - ref[2]) / np.abs(ref[2])
    if bf16:
      # bf16 matmul inputs: the kernel rounded raw pixels (mean removed
      # in the spectrum), the twin rounds mean-removed pixels, so the
      # sharpness statistic carries bf16 noise.
      assert np.median(sharp) < 0.02, np.median(sharp)
    else:
      np.testing.assert_allclose(got[2:], ref[2:], rtol=1e-3)

  @pytest.mark.parametrize('batch_size', [7, 4096])
  def test_batch_padding(self, batch_size):
    import jax.numpy as jnp
    pre, post = self._pair()
    offs = self._offsets('per_node', (9, 10))
    args = (jnp.asarray(pre), jnp.asarray(post), jnp.asarray(offs),
            (80, 80), (40, 40))
    ref = np.asarray(flow_field.targeted_flow_peaks(*args, max_offset=16,
                                                    batch_size=90))
    got = np.asarray(flow_field.targeted_flow_peaks(
        *args, max_offset=16, batch_size=batch_size))
    np.testing.assert_allclose(got, ref, rtol=1e-5, equal_nan=True)
