"""Multi-device tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sofima_tpu import mesh
from sofima_tpu.parallel import mesh_sharding


requires_multi = pytest.mark.skipif(
    len(jax.devices()) < 4, reason='needs >=4 virtual devices')


def _config(**kw):
  defaults = dict(dt=0.001, gamma=0.0, k0=0.05, k=0.1, stride=(40, 40),
                  num_iters=200, max_iters=20000, stop_v_max=0.001,
                  dt_max=100.0)
  defaults.update(kw)
  return mesh.IntegrationConfig(**defaults)


class TestShardedRelax:

  @requires_multi
  def test_matches_single_device_2d(self):
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(2, 1, 16, 12).astype(np.float32))
    prev = jnp.zeros_like(x)
    cfg = _config()

    ref, _, _ = mesh.relax_mesh_fused(x, prev, cfg)

    dmesh = mesh_sharding.make_mesh(4)
    out, e_hist, steps = mesh_sharding.relax_mesh_sharded(
        x, prev, cfg, dmesh)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-3)
    assert np.isfinite(np.asarray(e_hist)[0])

  @requires_multi
  def test_2d_device_mesh_matches_single_device(self):
    # Round-3: (y, x) 2-D sharding with corner-correct halo exchange
    # (diagonal springs cross tile corners) and NaN auto-pad on both
    # dims (18x14 over a 2x4 device grid).
    rng = np.random.RandomState(7)
    x = jnp.asarray(rng.randn(2, 1, 18, 14).astype(np.float32))
    prev = jnp.zeros_like(x)
    cfg = _config()
    ref, _, _ = mesh.relax_mesh_fused(x, prev, cfg)
    dmesh = mesh_sharding.make_mesh_2d(2, 4)
    out, e_hist, _ = mesh_sharding.relax_mesh_sharded(x, prev, cfg,
                                                      dmesh)
    assert out.shape == x.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-3)
    assert np.isfinite(np.asarray(e_hist)[0])

  @requires_multi
  def test_autopads_indivisible_y(self):
    # 18 rows over 4 devices: NaN-row padding, exact crop (round 3).
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.randn(2, 1, 18, 12).astype(np.float32))
    prev = jnp.zeros_like(x)
    cfg = _config()
    ref, _, _ = mesh.relax_mesh_fused(x, prev, cfg)
    dmesh = mesh_sharding.make_mesh(4)
    out, _, _ = mesh_sharding.relax_mesh_sharded(x, prev, cfg, dmesh)
    assert out.shape == x.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-3)

  @requires_multi
  def test_autopad_with_drift_removal_matches(self):
    # Auto-padded NaN nodes carry finite zero velocities; the drift
    # mean must be masked by node presence (isfinite(x)) or the padded
    # divisor diverges the sharded trajectory from the single-device
    # one (advisor round-3 finding).
    rng = np.random.RandomState(11)
    x = jnp.asarray(rng.randn(2, 1, 18, 12).astype(np.float32))
    prev = x + jnp.asarray(
        rng.randn(2, 1, 18, 12).astype(np.float32) * 0.1)
    cfg = _config(remove_drift=True)
    ref, _, _ = mesh.relax_mesh_fused(x, prev, cfg)
    dmesh = mesh_sharding.make_mesh(4)
    out, _, _ = mesh_sharding.relax_mesh_sharded(x, prev, cfg, dmesh)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-3)

  @requires_multi
  def test_matches_single_device_3d(self):
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(3, 4, 8, 6).astype(np.float32))
    prev = jnp.zeros_like(x)
    cfg = _config(stride=(40, 40, 40))

    ref, _, _ = mesh.relax_mesh_fused(
        x, prev, cfg, mesh_force=mesh.elastic_mesh_3d)
    dmesh = mesh_sharding.make_mesh(4)
    out, _, _ = mesh_sharding.relax_mesh_sharded(x, prev, cfg, dmesh, dim=3)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-3)

  @requires_multi
  def test_2d_device_mesh_matches_single_device_3d(self):
    # Round-5: (y, x) 2-D device meshes for dim=3 LICONN-style volumes
    # (z unsharded). The 26-neighbor edge/corner links cross tile
    # corners diagonally in (y, x); the two-hop corner halo transport
    # must carry them for every z plane. Indivisible extents (10x14
    # over 2x4 devices) exercise the NaN auto-pad on both dims.
    rng = np.random.RandomState(13)
    x = jnp.asarray(rng.randn(3, 4, 10, 14).astype(np.float32))
    prev = jnp.zeros_like(x)
    cfg = _config(stride=(40, 40, 40))
    ref, _, _ = mesh.relax_mesh_fused(
        x, prev, cfg, mesh_force=mesh.elastic_mesh_3d)
    dmesh = mesh_sharding.make_mesh_2d(2, 4)
    out, e_hist, _ = mesh_sharding.relax_mesh_sharded(x, prev, cfg,
                                                      dmesh, dim=3)
    assert out.shape == x.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-3)
    assert np.isfinite(np.asarray(e_hist)[0])

  @requires_multi
  def test_halo_force_equivalence(self):
    # Sharded force field == single-device force field, exactly.
    rng = np.random.RandomState(2)
    x = rng.randn(2, 1, 16, 8).astype(np.float32)
    ref = np.asarray(mesh.inplane_force(jnp.asarray(x), 0.1, (40, 40)))

    dmesh = mesh_sharding.make_mesh(4, 'my')
    from jax.sharding import PartitionSpec as P
    force = mesh_sharding._sharded_force_2d('my')
    f = mesh_sharding.shard_map(
        lambda xl: force(xl, 0.1, (40, 40)), mesh=dmesh,
        in_specs=P(None, None, 'my', None),
        out_specs=P(None, None, 'my', None))(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(f), ref, atol=1e-5)

  @requires_multi
  def test_sharded_flow_step(self):
    rng = np.random.RandomState(0)
    img = rng.rand(64, 64).astype(np.float32)
    post = np.roll(img, (2, -1), (0, 1))
    dmesh = mesh_sharding.make_mesh(4, 'mesh_y')
    run = mesh_sharding.sharded_flow_step(dmesh, 'mesh_y')
    starts = jnp.asarray(
        np.array([[y * 8, x * 8] for y in range(4) for x in range(4)],
                 np.int32))
    peaks = np.asarray(run(jnp.asarray(img), jnp.asarray(post), starts,
                           (24, 24)))
    assert peaks.shape == (16, 4)
    valid = np.isfinite(peaks[:, 0])
    assert valid.any()
    np.testing.assert_array_equal(peaks[valid, 0], 1.0)   # x = -(-1)
    np.testing.assert_array_equal(peaks[valid, 1], -2.0)  # y = -2

  @requires_multi
  def test_sharded_with_injected_force(self):
    # An injected base force (here the XLA stencil behind a wrapper) runs
    # per shard and must give the same sharded solution.
    from sofima_tpu import mesh as mesh_lib
    calls = []

    def force(x, k, stride, prefer_orig_order=False):
      calls.append(x.shape)
      return mesh_lib.inplane_force(x, k, stride, prefer_orig_order)

    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.randn(2, 1, 16, 8).astype(np.float32))
    prev = jnp.zeros_like(x)
    cfg = _config(num_iters=100, max_iters=2000)
    dmesh = mesh_sharding.make_mesh(4)
    ref, _, _ = mesh_sharding.relax_mesh_sharded(x, prev, cfg, dmesh)
    out, _, _ = mesh_sharding.relax_mesh_sharded(
        x, prev, cfg, dmesh,
        base_force=force)
    assert calls, 'injected force was not traced'
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-3)


class TestShardedDenseFlow:

  @requires_multi
  @pytest.mark.parametrize('mode', ['padfield', 'circular'])
  def test_matches_single_device(self, mode):
    from sofima_tpu import flow_field
    rng = np.random.RandomState(1)
    # Band-limited texture so correlation peaks are well defined.
    noise = rng.rand(160, 128).astype(np.float32)
    f = np.fft.rfft2(noise)
    fy = np.fft.fftfreq(160)[:, None]
    fx = np.fft.rfftfreq(128)[None, :]
    f *= np.exp(-((fx**2 + fy**2) / (2 * 0.1**2)))
    pre = np.fft.irfft2(f, s=(160, 128)).astype(np.float32)
    post = np.roll(pre, (3, -2), (0, 1))

    patch, step = (40, 40), (10, 10)
    kw = dict(circular=(mode == 'circular'))
    ref = np.asarray(flow_field.dense_flow_field(
        jnp.asarray(pre), jnp.asarray(post), patch, step, batch_size=64,
        **kw))

    dmesh = mesh_sharding.make_mesh(4, 'mesh_y')
    out = np.asarray(mesh_sharding.dense_flow_field_sharded(
        dmesh, pre, post, patch, step, batch_size=64, **kw))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-3, equal_nan=True)
    # Sanity: the known roll is recovered in the interior.
    interior = np.s_[2:-2, 2:-2]
    assert np.nanmedian(ref[0][interior]) == 2.0
    assert np.nanmedian(out[0][interior]) == 2.0

  @requires_multi
  def test_autopads_unaligned_strips(self):
    # Indivisible heights are padded internally (round-3: auto-pad
    # instead of raising); results must equal the single-device run.
    from sofima_tpu import flow_field
    rng = np.random.RandomState(3)
    noise = rng.rand(150, 128).astype(np.float32)
    f = np.fft.rfft2(noise)
    fy = np.fft.fftfreq(150)[:, None]
    fx = np.fft.rfftfreq(128)[None, :]
    f *= np.exp(-((fx**2 + fy**2) / (2 * 0.1**2)))
    pre = np.fft.irfft2(f, s=(150, 128)).astype(np.float32)
    post = np.roll(pre, (2, -1), (0, 1))
    patch, step = (40, 40), (10, 10)
    ref = np.asarray(flow_field.dense_flow_field(
        jnp.asarray(pre), jnp.asarray(post), patch, step, batch_size=64))
    dmesh = mesh_sharding.make_mesh(4, 'mesh_y')
    out = np.asarray(mesh_sharding.dense_flow_field_sharded(
        dmesh, pre, post, patch, step, batch_size=64))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-3, equal_nan=True)

  @requires_multi
  def test_masked_matches_single_device(self):
    from sofima_tpu import flow_field
    rng = np.random.RandomState(2)
    noise = rng.rand(160, 128).astype(np.float32)
    f = np.fft.rfft2(noise)
    fy = np.fft.fftfreq(160)[:, None]
    fx = np.fft.rfftfreq(128)[None, :]
    f *= np.exp(-((fx**2 + fy**2) / (2 * 0.1**2)))
    pre = np.fft.irfft2(f, s=(160, 128)).astype(np.float32)
    post = np.roll(pre, (3, -2), (0, 1))
    pre_mask = np.zeros(pre.shape, bool)
    pre_mask[40:70, :] = True  # invalid band crossing shard boundaries

    patch, step = (40, 40), (10, 10)
    ref = np.asarray(flow_field.dense_flow_field(
        jnp.asarray(pre), jnp.asarray(post), patch, step, batch_size=64,
        circular=True, pre_mask=jnp.asarray(pre_mask)))

    dmesh = mesh_sharding.make_mesh(4, 'mesh_y')
    out = np.asarray(mesh_sharding.dense_flow_field_sharded(
        dmesh, pre, post, patch, step, batch_size=64, circular=True,
        pre_mask=pre_mask))
    np.testing.assert_allclose(out, ref, atol=1e-3, equal_nan=True)
