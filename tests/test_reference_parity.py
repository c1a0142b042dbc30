"""Numerical parity against the reference implementation (test oracle).

Loads the reference modules from /root/reference (read-only) with shimmed
`connectomics` dependencies and compares outputs of our JAX
implementations on random inputs. Skipped when the reference tree is not
mounted. The reference code is used strictly as an oracle — nothing from
it ships in the package.
"""

import importlib.util
import sys
import types

import numpy as np
import pytest

REFERENCE = '/root/reference'

pytestmark = pytest.mark.skipif(
    not __import__('os').path.isdir(REFERENCE),
    reason='reference tree not mounted')


def _install_shims():
  """Provides the minimal connectomics surface the reference imports."""
  from sofima_tpu.utils import bounding_box as bb
  from sofima_tpu.utils import geom

  con = types.ModuleType('connectomics')
  common = types.ModuleType('connectomics.common')

  bb_mod = types.ModuleType('connectomics.common.bounding_box')
  bb_mod.BoundingBox = bb.BoundingBox
  bb_mod.BoundingBoxBase = bb.BoundingBox

  geom_mod = types.ModuleType('connectomics.common.geom_utils')
  geom_mod.integral_image = geom.integral_image_np
  geom_mod.query_integral_image = geom.query_integral_image

  utils_mod = types.ModuleType('connectomics.common.utils')

  def batch(items, size):
    for i in range(0, len(items), size):
      yield items[i:i + size]

  utils_mod.batch = batch

  sys.modules.setdefault('connectomics', con)
  sys.modules['connectomics.common'] = common
  sys.modules['connectomics.common.bounding_box'] = bb_mod
  sys.modules['connectomics.common.geom_utils'] = geom_mod
  sys.modules['connectomics.common.utils'] = utils_mod
  common.bounding_box = bb_mod
  common.geom_utils = geom_mod
  common.utils = utils_mod
  con.common = common


def _load_reference(name):
  _install_shims()
  full = f'ref_sofima_{name}'
  if full in sys.modules:
    return sys.modules[full]
  # The reference does package-relative imports via 'sofima.*'; alias it.
  if 'sofima' not in sys.modules:
    pkg = types.ModuleType('sofima')
    pkg.__path__ = [REFERENCE]
    sys.modules['sofima'] = pkg
  spec = importlib.util.spec_from_file_location(
      f'sofima.{name}', f'{REFERENCE}/{name}.py')
  mod = importlib.util.module_from_spec(spec)
  sys.modules[f'sofima.{name}'] = mod
  spec.loader.exec_module(mod)
  sys.modules[full] = mod
  return mod


class TestMeshParity:

  def test_inplane_force_exact(self):
    import jax.numpy as jnp
    ref_mesh = _load_reference('mesh')
    from sofima_tpu import mesh as our_mesh
    rng = np.random.RandomState(0)
    x = rng.randn(2, 2, 12, 14).astype(np.float32) * 5
    for prefer in (False, True):
      theirs = np.asarray(ref_mesh.inplane_force(
          jnp.asarray(x), 0.1, (40, 40), prefer))
      ours = np.asarray(our_mesh.inplane_force(
          jnp.asarray(x), 0.1, (40, 40), prefer))
      np.testing.assert_allclose(ours, theirs, atol=1e-5, err_msg=str(prefer))

  def test_elastic_mesh_3d_exact(self):
    import jax.numpy as jnp
    ref_mesh = _load_reference('mesh')
    from sofima_tpu import mesh as our_mesh
    rng = np.random.RandomState(1)
    x = rng.randn(3, 4, 6, 5).astype(np.float32) * 5
    theirs = np.asarray(ref_mesh.elastic_mesh_3d(jnp.asarray(x), 0.1, 40.0))
    ours = np.asarray(our_mesh.elastic_mesh_3d(jnp.asarray(x), 0.1, 40.0))
    np.testing.assert_allclose(ours, theirs, atol=1e-4)

  def test_velocity_verlet_trajectory(self):
    import jax.numpy as jnp
    ref_mesh = _load_reference('mesh')
    from sofima_tpu import mesh as our_mesh
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(2, 1, 10, 10).astype(np.float32))
    v = jnp.zeros_like(x)
    prev = jnp.zeros_like(x)
    ref_cfg = ref_mesh.IntegrationConfig(
        dt=0.001, gamma=0.0, k0=0.05, k=0.1, stride=(40, 40),
        num_iters=200, max_iters=200, stop_v_max=0.0, dt_max=100.0)
    our_cfg = our_mesh.IntegrationConfig(
        dt=0.001, gamma=0.0, k0=0.05, k=0.1, stride=(40, 40),
        num_iters=200, max_iters=200, stop_v_max=0.0, dt_max=100.0)
    theirs = ref_mesh.velocity_verlet(x, v, prev, ref_cfg, force_cap=1e6)
    ours = our_mesh.velocity_verlet(x, v, prev, our_cfg, force_cap=1e6)
    np.testing.assert_allclose(np.asarray(ours[0]), np.asarray(theirs[0]),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(ours[1]), np.asarray(theirs[1]),
                               atol=1e-4)

  def test_relax_mesh_fixed_point(self):
    import jax.numpy as jnp
    ref_mesh = _load_reference('mesh')
    from sofima_tpu import mesh as our_mesh
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(2, 1, 8, 8).astype(np.float32))
    prev = jnp.asarray(rng.randn(2, 1, 8, 8).astype(np.float32) * 0.5)
    kwargs = dict(dt=0.001, gamma=0.0, k0=0.1, k=0.1, stride=(40, 40),
                  num_iters=200, max_iters=20000, stop_v_max=0.0005,
                  dt_max=100.0)
    theirs, _, _ = ref_mesh.relax_mesh(
        x, prev, ref_mesh.IntegrationConfig(**kwargs))
    ours, _, _ = our_mesh.relax_mesh(
        x, prev, our_mesh.IntegrationConfig(**kwargs))
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               atol=5e-3)


class TestFlowParity:

  def test_masked_xcorr_matches(self):
    ref_ff = _load_reference('flow_field')
    from sofima_tpu import flow_field as our_ff
    rng = np.random.RandomState(0)
    prev = rng.rand(3, 24, 24).astype(np.float32)
    curr = rng.rand(3, 24, 24).astype(np.float32)
    prev -= prev.mean(axis=(1, 2), keepdims=True)
    curr -= curr.mean(axis=(1, 2), keepdims=True)
    mask = np.zeros((3, 24, 24), bool)
    mask[:, :6, :6] = True
    theirs = np.asarray(ref_ff.masked_xcorr(
        prev, curr, prev_mask=mask, curr_mask=None, use_jax=True, dim=2))
    ours = np.asarray(our_ff.masked_xcorr(
        prev, curr, prev_mask=mask, curr_mask=None, use_jax=True, dim=2))
    np.testing.assert_allclose(ours, theirs, atol=2e-3)
    # Identical peak locations per batch item.
    for b in range(3):
      assert (np.unravel_index(np.argmax(ours[b]), ours[b].shape)
              == np.unravel_index(np.argmax(theirs[b]), theirs[b].shape))

  def test_flow_field_calculator_matches(self):
    ref_ff = _load_reference('flow_field')
    from sofima_tpu import flow_field as our_ff
    rng = np.random.RandomState(1)
    noise = rng.rand(240, 240).astype(np.float32)
    f2 = np.fft.rfft2(noise)
    fy = np.fft.fftfreq(240)[:, None]
    fx = np.fft.rfftfreq(240)[None, :]
    f2 *= np.exp(-((fx**2 + fy**2) / (2 * 0.1**2)))
    tex = (np.fft.irfft2(f2, s=(240, 240)) * 1000).astype(np.float32)
    post = np.roll(tex, (3, -5), (0, 1))

    theirs = ref_ff.JAXMaskedXCorrWithStatsCalculator().flow_field(
        tex, post, patch_size=80, step=40, batch_size=8)
    ours = our_ff.JAXMaskedXCorrWithStatsCalculator().flow_field(
        tex, post, patch_size=80, step=40, batch_size=8)
    # Flow components must match exactly (integer peaks).
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    # Stats channels within float tolerance.
    np.testing.assert_allclose(ours[2], theirs[2], rtol=1e-3)


class TestMapUtilsParity:

  def test_compose_maps_fast_matches(self):
    import jax.numpy as jnp
    ref_mu = _load_reference('map_utils')
    from sofima_tpu import map_utils as our_mu
    rng = np.random.RandomState(0)
    m1 = rng.uniform(-3, 3, (2, 2, 10, 12)).astype(np.float32)
    m2 = rng.uniform(-3, 3, (2, 2, 10, 12)).astype(np.float32)
    theirs = np.asarray(ref_mu.compose_maps_fast(
        jnp.asarray(m1), (0, 0), 4.0, jnp.asarray(m2), (0, 0), 4.0))
    ours = np.asarray(our_mu.compose_maps_fast(
        jnp.asarray(m1), (0, 0), 4.0, jnp.asarray(m2), (0, 0), 4.0))
    np.testing.assert_allclose(ours, theirs, atol=1e-4)

  def test_invert_map_close_to_reference(self):
    from sofima_tpu import map_utils as our_mu
    from sofima_tpu.utils.bounding_box import BoundingBox
    ref_mu = _load_reference('map_utils')
    y, x = np.mgrid[:16, :16].astype(np.float32)
    m = np.stack([1.5 * np.sin(2 * np.pi * y / 16),
                  1.5 * np.cos(2 * np.pi * x / 16)])[:, None]
    box = BoundingBox(start=(0, 0, 0), size=(16, 16, 1))
    theirs = ref_mu.invert_map(m, box, box, 2.0)
    ours = our_mu.invert_map(m, box, box, 2.0)
    both = np.isfinite(theirs[0, 0]) & np.isfinite(ours[0, 0])
    assert both.mean() > 0.6
    np.testing.assert_allclose(ours[:, :, both], theirs[:, :, both],
                               atol=0.1)

  def test_fill_missing_close_to_reference(self):
    ref_mu = _load_reference('map_utils')
    from sofima_tpu import map_utils as our_mu
    y, x = np.mgrid[:16, :16].astype(np.float32)
    m = np.stack([0.3 * x + 0.1 * y, 0.2 * y - 0.1 * x])[:, None]
    damaged = m.copy()
    damaged[:, :, 5:9, 5:9] = np.nan
    theirs = ref_mu.fill_missing(damaged)
    ours = our_mu.fill_missing(damaged)
    hole = np.s_[:, :, 5:9, 5:9]
    np.testing.assert_allclose(ours[hole], theirs[hole], atol=0.1)


class TestStitchRigidParity:

  def test_interpolate_missing_offsets_tiebreaks(self):
    """Exact match vs the reference on an asymmetric inf/NaN grid.

    Covers the semantics the reference leaves implicit: the finiteness
    gate reads channel 0 only, candidates at equal radius on BOTH sides
    are averaged, the search stops at the first radius with any hit,
    and in-place filling lets earlier-processed entries seed later ones
    (row-major processing order).
    """
    for dep in ('flow_field', 'mesh'):
      _load_reference(dep)
    ref_sr = _load_reference('stitch_rigid')
    from sofima_tpu import stitch_rigid as our_sr

    rng = np.random.RandomState(7)
    conn = rng.randn(2, 1, 5, 7).astype(np.float64)
    # Asymmetric damage: isolated infs, an inf RUN (exercises the
    # in-place cascade), an inf next to a NaN (missing tile must not be
    # used as a neighbor), and a channel-0-finite/channel-1-inf entry
    # (the gate reads channel 0 only).
    conn[:, 0, 1, 2] = np.inf
    conn[:, 0, 3, 1:4] = np.inf
    conn[:, 0, 0, 5] = np.inf
    conn[:, 0, 0, 6] = np.nan
    conn[1, 0, 2, 4] = np.inf  # channel 0 stays finite here
    conn[:, 0, 4, 0] = np.inf  # edge entry: one-sided neighbors only

    theirs = ref_sr.interpolate_missing_offsets(conn.copy(), axis=-1)
    ours = our_sr.interpolate_missing_offsets(conn.copy(), axis=-1)
    np.testing.assert_array_equal(ours, theirs)

    theirs_y = ref_sr.interpolate_missing_offsets(conn.copy(), axis=-2)
    ours_y = our_sr.interpolate_missing_offsets(conn.copy(), axis=-2)
    np.testing.assert_array_equal(ours_y, theirs_y)
