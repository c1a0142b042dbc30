"""Aux subsystem tests: metrics, checkpointing, distributed partitioning,
volume backends, registration ops."""

import numpy as np
import pytest

import jax.numpy as jnp

from sofima_tpu import mesh
from sofima_tpu.ops import registration
from sofima_tpu.parallel import distributed
from sofima_tpu.utils import checkpoint, metrics
from sofima_tpu.utils.bounding_box import BoundingBox
from sofima_tpu.utils.volume import InMemoryVolume, TensorStoreVolume


class TestMetrics:

  def test_counters_and_timers(self):
    metrics.registry().reset()
    metrics.counter('ns', 'items').inc(3)
    with metrics.timer_counter('ns', 'stage'):
      pass
    snap = metrics.registry().snapshot()
    assert snap['counters']['ns/items'] == 3
    assert snap['counters']['ns/stage-calls'] == 1
    assert 'ns/stage' in snap['timings_s']

  def test_merge(self):
    metrics.registry().reset()
    metrics.counter('a', 'x').inc()
    snap = metrics.registry().snapshot()
    metrics.registry().merge(snap)
    assert metrics.registry().get_counter('a', 'x') == 2

  def test_trace_context(self):
    with metrics.trace('test-trace'):
      pass
    assert metrics.registry().get_counter('trace', 'test-trace-calls') >= 1


class TestCheckpoint:

  def test_solver_state_roundtrip(self, tmp_path):
    path = str(tmp_path / 'state.npz')
    x = np.random.rand(2, 1, 4, 4).astype(np.float32)
    checkpoint.save_solver_state(path, x, v=np.zeros_like(x),
                                 fire_state={'dt': 0.5}, step=100)
    state = checkpoint.load_solver_state(path)
    np.testing.assert_array_equal(state['x'], x)
    assert state['step'] == 100
    assert float(state['fire_dt']) == 0.5

  def test_load_missing(self, tmp_path):
    assert checkpoint.load_solver_state(str(tmp_path / 'nope.npz')) == {}

  def test_mesh_npz_roundtrip(self, tmp_path):
    path = str(tmp_path / 'mesh.npz')
    x = np.random.rand(2, 3, 4, 4).astype(np.float32)
    k2i = {(0, 0): 0, (1, 0): 1, (0, 1): 2}
    checkpoint.save_mesh_npz(path, x, k2i)
    x2, k2 = checkpoint.load_mesh_npz(path)
    np.testing.assert_array_equal(x2, x)
    assert k2 == k2i

  def test_checkpointing_relaxer_resumes(self, tmp_path):
    path = str(tmp_path / 'relax.npz')
    cfg = mesh.IntegrationConfig(
        dt=0.001, gamma=0.0, k0=0.05, k=0.1, stride=(40, 40),
        num_iters=100, max_iters=10000, stop_v_max=0.001, dt_max=100.0)
    rng = np.random.RandomState(0)
    x0 = jnp.asarray(rng.randn(2, 1, 8, 8).astype(np.float32))
    prev = jnp.zeros_like(x0)
    relaxer = checkpoint.CheckpointingRelaxer(path, cfg, save_every=1)
    x, steps = relaxer.run(x0, prev)
    np.testing.assert_allclose(np.asarray(x), 0.0, atol=0.2)
    # Resume: solved state is already converged -> quick exit.
    x2, steps2 = relaxer.run(x0, prev)
    assert steps2 >= steps
    np.testing.assert_allclose(np.asarray(x2), 0.0, atol=0.2)


class TestDistributed:

  def test_partition_work(self):
    boxes = [BoundingBox(start=(i, 0, 0), size=(1, 1, 1))
             for i in range(10)]
    p0 = distributed.partition_work(boxes, num_parts=3, part_index=0)
    p1 = distributed.partition_work(boxes, num_parts=3, part_index=1)
    p2 = distributed.partition_work(boxes, num_parts=3, part_index=2)
    assert len(p0) + len(p1) + len(p2) == 10
    assert len({id(b) for part in (p0, p1, p2) for b in part}) == 10

  def test_single_process_noop(self):
    distributed.initialize(num_processes=1)
    assert distributed.process_count() == 1
    distributed.barrier()

  def test_device_mesh(self):
    m = distributed.device_mesh(('a',))
    assert 'a' in m.shape


class TestVolumes:

  def test_in_memory_oob_reads(self):
    data = np.ones((1, 2, 4, 4), np.float32)
    vol = InMemoryVolume(data)
    out = vol[(slice(None), slice(0, 2), slice(-2, 6), slice(0, 4))]
    assert out.shape == (1, 2, 8, 4)
    assert np.isnan(out[:, :, :2]).all()
    assert (out[:, :, 2:6] == 1).all()

  def test_tensorstore_volume(self, tmp_path):
    vol = TensorStoreVolume.create(str(tmp_path / 'v'), (1, 2, 8, 8),
                                   np.float32, chunk_size=(1, 1, 4, 4))
    data = np.random.rand(1, 1, 4, 4).astype(np.float32)
    box = BoundingBox(start=(2, 2, 0), size=(4, 4, 1))
    vol.write(data, box)
    out = vol[box.to_slice4d()]
    np.testing.assert_array_equal(out, data)
    clipped = vol.clip_box_to_volume(
        BoundingBox(start=(6, 6, 0), size=(4, 4, 4)))
    np.testing.assert_array_equal(clipped.size, [2, 2, 2])


class TestRegistration:

  def test_phase_cross_correlation(self):
    rng = np.random.RandomState(0)
    img = rng.rand(64, 64).astype(np.float32)
    moved = np.roll(img, (5, -3), (0, 1))
    # Returns the correction to apply to `moving` (skimage convention).
    shift, err, _ = registration.phase_cross_correlation(img, moved)
    np.testing.assert_array_equal(shift, [-5, 3])

  def test_phase_cross_correlation_3d(self):
    rng = np.random.RandomState(1)
    vol = rng.rand(16, 32, 32).astype(np.float32)
    moved = np.roll(vol, (2, -4, 6), (0, 1, 2))
    shift, _, _ = registration.phase_cross_correlation(
        vol, moved, normalization=None)
    np.testing.assert_array_equal(shift, [-2, 4, -6])


class TestMultiProcess:
  """Real multi-process runs; every worker pins itself to the CPU
  (tests/distributed_worker.py), so no two processes share a GPU."""

  def test_two_process_distributed_run(self, tmp_path):
    import os
    import socket
    import subprocess
    import sys
    # Pick a free port for the coordinator.
    with socket.socket() as s:
      s.bind(('localhost', 0))
      port = s.getsockname()[1]
    coordinator = f'localhost:{port}'
    worker = os.path.join(os.path.dirname(__file__),
                          'distributed_worker.py')
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coordinator, '2', str(i),
             str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
      try:
        out, _ = p.communicate(timeout=180)
      except subprocess.TimeoutExpired:
        for q in procs:
          q.kill()
        pytest.fail('distributed workers timed out')
      outs.append(out)
    assert all(p.returncode == 0 for p in procs), outs
    assert 'DISTRIBUTED_OK' in outs[0], outs[0][-2000:]

  def test_two_process_flow_pipeline(self, tmp_path):
    """Cross-host chunk DP + intra-host sharded dense flow, per-host
    timings recorded (the production scaling combination)."""
    import json
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
      s.bind(('localhost', 0))
      port = s.getsockname()[1]
    coordinator = f'localhost:{port}'
    worker = os.path.join(os.path.dirname(__file__),
                          'distributed_worker.py')
    env = dict(os.environ)
    env.pop('XLA_FLAGS', None)  # workers pick their own device count
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coordinator, '2', str(i),
             str(tmp_path), 'flow'],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for i in range(2)
    ]
    outs = []
    for p in procs:
      try:
        out, _ = p.communicate(timeout=300)
      except subprocess.TimeoutExpired:
        for q in procs:
          q.kill()
        pytest.fail('distributed flow workers timed out')
      outs.append(out)
    assert all(p.returncode == 0 for p in procs), outs
    assert 'DISTRIBUTED_FLOW_OK' in outs[0], outs[0][-2000:]
    for i in range(2):
      with open(tmp_path / f'host{i}.json') as f:
        rec = json.load(f)
      assert rec['subvolumes_done'] > 0
      assert rec['chunk_dp_s'] > 0

  def test_four_process_flow_pipeline(self, tmp_path):
    """Round-3 scale validation beyond 2 processes: the same chunk-DP +
    intra-host sharded-flow combination at 4 host processes (8 virtual
    devices total). Output totals must match regardless of process
    count (idempotent disjoint chunk writes)."""
    import json
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
      s.bind(('localhost', 0))
      port = s.getsockname()[1]
    coordinator = f'localhost:{port}'
    worker = os.path.join(os.path.dirname(__file__),
                          'distributed_worker.py')
    env = dict(os.environ)
    env.pop('XLA_FLAGS', None)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coordinator, '4', str(i),
             str(tmp_path), 'flow'],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for i in range(4)
    ]
    outs = []
    for p in procs:
      try:
        out, _ = p.communicate(timeout=420)
      except subprocess.TimeoutExpired:
        for q in procs:
          q.kill()
        pytest.fail('4-process distributed flow workers timed out')
      outs.append(out)
    assert all(p.returncode == 0 for p in procs), outs
    assert 'DISTRIBUTED_FLOW_OK' in outs[0], outs[0][-2000:]
    done = 0
    for i in range(4):
      with open(tmp_path / f'host{i}.json') as f:
        rec = json.load(f)
      done += rec['subvolumes_done']
    assert done > 0
