"""Tests for the spring-mesh solver (physics invariants)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sofima_tpu import mesh


def _config(**kw):
  defaults = dict(dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40, 40),
                  num_iters=200, max_iters=20000, stop_v_max=0.001,
                  dt_max=100.0)
  defaults.update(kw)
  return mesh.IntegrationConfig(**defaults)


class TestForces:

  def test_zero_at_equilibrium_2d(self):
    x = jnp.zeros((2, 1, 8, 8))
    f = mesh.inplane_force(x, k=0.1, stride=(40, 40))
    np.testing.assert_allclose(np.asarray(f), 0.0, atol=1e-6)

  def test_zero_at_equilibrium_3d_with_batch(self):
    x = jnp.zeros((3, 5, 4, 6, 6))  # batch dim of 5
    f = mesh.elastic_mesh_3d(x, k=0.1, stride=40.0)
    assert f.shape == x.shape
    np.testing.assert_allclose(np.asarray(f), 0.0, atol=1e-5)

  def test_single_displaced_node_hooke(self):
    # Displace the center node of a 3x3 grid by +d in x; compute the
    # restoring force analytically from the 8 springs.
    k, s, d = 0.1, 10.0, 1.0
    x = np.zeros((2, 1, 3, 3), np.float32)
    x[0, 0, 1, 1] = d
    f = np.asarray(mesh.inplane_force(jnp.asarray(x), k=k, stride=(s, s)))

    # Horizontal springs: left spring stretched by d -> force -k*d;
    # right spring compressed by d -> force -k*d. Total: -2kd in x.
    fx = -2 * k * d
    # Vertical springs: length changes from s to sqrt(s^2+d^2).
    l = np.hypot(s, d)
    fx += -2 * k * (1 - s / l) * d
    # Diagonal springs (k/sqrt(2), rest length s*sqrt(2)).
    kd = k / np.sqrt(2)
    l0d = s * np.sqrt(2)
    for ex in (-1, 1):
      dx_vec = np.array([ex * s + d, s])
      l = np.linalg.norm(dx_vec)
      fdiag = -kd * (1 - l0d / l) * dx_vec
      fx += 2 * fdiag[0] * 1  # two springs per diagonal orientation
    np.testing.assert_allclose(f[0, 0, 1, 1], fx, rtol=1e-4)
    np.testing.assert_allclose(f[1, 0, 1, 1], 0.0, atol=1e-6)
    # Momentum conservation: forces sum to zero.
    np.testing.assert_allclose(f.sum(axis=(1, 2, 3)), 0.0, atol=1e-5)

  def test_2d_3d_consistency(self):
    # 3d force restricted to in-plane links must equal the 2d force.
    rng = np.random.RandomState(0)
    x2 = rng.randn(2, 1, 6, 6).astype(np.float32) * 2
    x3 = np.concatenate([x2, np.zeros((1, 1, 6, 6), np.float32)], axis=0)
    planar_links = [(1, 0, 0), (0, 1, 0), (1, 1, 0), (-1, 1, 0)]
    f3 = np.asarray(
        mesh.elastic_mesh_3d(jnp.asarray(x3), k=0.1, stride=40.0,
                             links=planar_links))
    f2 = np.asarray(mesh.inplane_force(jnp.asarray(x2), k=0.1,
                                       stride=(40, 40)))
    np.testing.assert_allclose(f3[:2], f2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(f3[2], 0.0, atol=1e-5)

  def test_nan_nodes_exert_no_force(self):
    x = np.zeros((2, 1, 5, 5), np.float32)
    x[:, 0, 2, 2] = np.nan
    f = np.asarray(mesh.inplane_force(jnp.asarray(x), k=0.1, stride=(40, 40)))
    # Neighbors of the NaN node see zero force (spring suppressed).
    assert np.isfinite(f[:, 0, 2, 1]).all()
    np.testing.assert_allclose(f[:, 0, 2, 1], 0.0, atol=1e-6)

  def test_prefer_orig_order_penalizes_fold(self):
    # Node order flip: with the fold-preventing formulation, the force
    # must push the flipped node back with greater magnitude.
    s = 10.0
    x = np.zeros((2, 1, 1, 2), np.float32)
    x[0, 0, 0, 1] = -15.0  # node 1 displaced past node 0 (fold)
    f_plain = np.asarray(
        mesh.inplane_force(jnp.asarray(x), k=0.1, stride=(s, s)))
    f_fold = np.asarray(
        mesh.inplane_force(jnp.asarray(x), k=0.1, stride=(s, s),
                           prefer_orig_order=True))
    # Plain Hooke: folded config is a second minimum; restoring force is
    # weaker (or wrong-signed) vs the fold-preventing variant.
    assert f_fold[0, 0, 0, 1] > f_plain[0, 0, 0, 1]
    assert f_fold[0, 0, 0, 1] > 0  # pushes back toward original order


class TestRelaxation:

  @pytest.mark.parametrize('fire', [True, False])
  def test_relaxes_to_prev_zero(self, fire):
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(2, 1, 10, 10).astype(np.float32))
    cfg = _config(fire=fire, gamma=0.0 if fire else 0.5, k0=0.05,
                  dt=0.001 if fire else 0.5)
    prev = jnp.zeros_like(x)
    out, e_kin, steps = mesh.relax_mesh(x, prev, cfg)
    out = np.asarray(out)
    assert steps < cfg.max_iters
    np.testing.assert_allclose(out, 0.0, atol=0.2)
    assert e_kin[-1] <= e_kin[0]

  def test_fused_matches_host_loop(self):
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(2, 1, 12, 12).astype(np.float32))
    prev = jnp.zeros_like(x)
    cfg = _config(k0=0.05)
    x_host, _, steps_host = mesh.relax_mesh(x, prev, cfg)
    x_dev, e_hist, steps_dev = mesh.relax_mesh_fused(x, prev, cfg)
    np.testing.assert_allclose(np.asarray(x_host), np.asarray(x_dev),
                               atol=5e-3)
    assert int(steps_dev) <= cfg.max_iters
    assert np.isfinite(np.asarray(e_hist)[0])

  def test_velocity_verlet_state_shapes(self):
    x = jnp.zeros((2, 1, 6, 6))
    v = jnp.zeros_like(x)
    cfg = _config(num_iters=10)
    state = mesh.velocity_verlet(x, v, None, cfg, force_cap=1e6)
    assert len(state) == 7  # FIRE state
    cfg2 = _config(num_iters=10, fire=False)
    state = mesh.velocity_verlet(x, v, None, cfg2, force_cap=1e6)
    assert len(state) == 3

  def test_force_cap_escalation(self):
    # With a tiny start cap the solver escalates to final_cap before
    # terminating.
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(2, 1, 8, 8).astype(np.float32))
    cfg = _config(start_cap=0.01, final_cap=10.0, cap_scale=2.0, k0=0.05,
                  num_iters=100, max_iters=50000)
    out, _, steps = mesh.relax_mesh(x, jnp.zeros_like(x), cfg)
    np.testing.assert_allclose(np.asarray(out), 0.0, atol=0.2)

  def test_prev_fn_hook(self):
    # prev_fn returning zeros behaves like prev=zeros.
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(2, 1, 8, 8).astype(np.float32))
    cfg = _config(k0=0.05)
    out1, _, _ = mesh.relax_mesh(x, jnp.zeros_like(x), cfg)
    out2, _, _ = mesh.relax_mesh(x, None, cfg, prev_fn=jnp.zeros_like)
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out2), atol=1e-4)

  def test_remove_drift(self):
    rng = np.random.RandomState(4)
    x = jnp.asarray(rng.randn(2, 1, 8, 8).astype(np.float32) + 5.0)
    cfg = _config(remove_drift=True, k0=0.0, num_iters=100, max_iters=2000,
                  stop_v_max=0.01)
    out, _, _ = mesh.relax_mesh(x, None, cfg)
    np.testing.assert_allclose(np.asarray(out).mean(axis=(1, 2, 3)), 0.0,
                               atol=1e-3)


class TestConfig:

  def test_hashable_and_json(self):
    cfg = _config()
    assert hash(cfg)
    text = cfg.to_json()
    back = mesh.IntegrationConfig.from_json(text)
    assert back == cfg


def _force_oracle(x, links, k_eff, stride_xyz, prefer_orig_order):
  """Per-link NumPy loop twin of mesh._spring_force (trailing grid axes)."""
  x = np.asarray(x, np.float64)
  dim = x.shape[0]
  grid = x.shape[-dim:]
  out = np.zeros_like(x)
  for idx in np.ndindex(*grid):
    for direction, k in zip(links, k_eff):
      e_zyx = direction[::-1]
      jdx = tuple(i + e for i, e in zip(idx, e_zyx))
      if not all(0 <= j < n for j, n in zip(jdx, grid)):
        continue
      l0_vec = np.array([stride_xyz[c] * direction[c] for c in range(dim)])
      l0 = np.linalg.norm(l0_vec)
      sel_i = (Ellipsis,) + idx
      sel_j = (Ellipsis,) + jdx
      xi = x[sel_i]
      xj = x[sel_j]
      d = xj - xi + l0_vec.reshape((dim,) + (1,) * (xi.ndim - 1))
      length = np.sqrt(np.sum(d * d, axis=0))
      with np.errstate(all='ignore'):
        if prefer_orig_order:
          factor = np.stack([
              direction[c] * np.sign(d[c]) if direction[c] != 0
              else np.ones_like(d[c]) for c in range(dim)])
          f = -k * (1.0 - l0 * factor / length) * d
        else:
          f = -k * (1.0 - l0 / length) * d
      f = np.nan_to_num(f, nan=0.0, posinf=0.0, neginf=0.0)
      out[sel_j] += f
      out[sel_i] -= f
  return out


class TestSpringForceOracle:
  """XLA spring stencils vs a per-link NumPy loop."""

  @pytest.mark.parametrize('stride', [(40.0, 40.0), (30.0, 50.0)])
  @pytest.mark.parametrize('prefer_orig_order', [False, True])
  @pytest.mark.parametrize('nan_nodes', [False, True])
  def test_inplane_force(self, nan_nodes, prefer_orig_order, stride):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 2, 6, 7).astype(np.float32) * 5
    x[0, 0, 3, 3] = -60.0  # a folded node
    if nan_nodes:
      x[:, 0, 2, 4] = np.nan
      x[:, 1, 0, :2] = np.nan
    got = np.asarray(mesh.inplane_force(jnp.asarray(x), 0.1, stride,
                                        prefer_orig_order))
    k_diag = 0.1 / np.sqrt(2.0)
    ref = _force_oracle(x, mesh.INPLANE_LINK_DIRECTIONS,
                        (0.1, 0.1, k_diag, k_diag), stride,
                        prefer_orig_order)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

  @pytest.mark.parametrize('stride', [(40.0, 40.0, 40.0),
                                      (40.0, 30.0, 20.0)])
  @pytest.mark.parametrize('prefer_orig_order', [False, True])
  def test_elastic_mesh_3d(self, prefer_orig_order, stride):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 4, 5, 6).astype(np.float32) * 5
    x[:, 1, 2, 3] = np.nan
    x[0, 2, 2, 2] = -50.0
    got = np.asarray(mesh.elastic_mesh_3d(jnp.asarray(x), 0.2, stride,
                                          prefer_orig_order))
    k_eff = [0.2 * stride[0] / np.linalg.norm(
        [stride[c] * d[c] for c in range(3)])
             for d in mesh.MESH_LINK_DIRECTIONS]
    ref = _force_oracle(x, mesh.MESH_LINK_DIRECTIONS, k_eff, stride,
                        prefer_orig_order)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
