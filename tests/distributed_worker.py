"""Worker process for the multi-host tests (run via subprocess).

Usage: python distributed_worker.py <coordinator> <num_procs> <proc_id>
       <workdir> [mode]

Modes:
  double  chunked doubling job against a shared TensorStore output
          (framework smoke test)
  flow    a real pipeline stage: EstimateFlow chunk-DP across processes
          into a shared TensorStore flow volume, PLUS the intra-host
          spatially-sharded dense flow (2-device local mesh, ppermute
          halos) validated against the single-device kernel — the
          production combination of cross-host chunk parallelism with
          in-host device sharding. Per-host wall times are recorded to
          <workdir>/host<i>.json.

Every worker pins itself to the CPU backend (with virtual local
devices), so several workers can run on one machine without competing
for an accelerator: a JAX process reserves most of a GPU's memory when
it first uses it, so one card holds one process.
"""

import json
import os
import sys
import time


def _setup(num_procs_local_devices=2):
  flags = os.environ.get('XLA_FLAGS', '')
  if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags +
        f' --xla_force_host_platform_device_count={num_procs_local_devices}'
    ).strip()
  import jax
  jax.config.update('jax_platforms', 'cpu')
  sys.path.insert(0, __file__.rsplit('/', 2)[0])


def _texture(n, seed=0):
  import numpy as np
  rng = np.random.RandomState(seed)
  noise = rng.rand(n, n).astype(np.float32)
  f = np.fft.rfft2(noise)
  fy = np.fft.fftfreq(n)[:, None]
  fx = np.fft.rfftfreq(n)[None, :]
  f *= np.exp(-((fx**2 + fy**2) / (2 * 0.1**2)))
  tex = np.fft.irfft2(f, s=(n, n))
  return ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.float32)


def run_double(coordinator, num_procs, proc_id, workdir):
  import numpy as np
  from sofima_tpu.parallel import distributed
  from sofima_tpu.processor import runner
  from sofima_tpu.utils.volume import InMemoryVolume, TensorStoreVolume

  distributed.initialize(coordinator_address=coordinator,
                         num_processes=num_procs, process_id=proc_id)
  assert distributed.process_count() == num_procs

  rng = np.random.RandomState(0)  # same data on every process
  data = rng.rand(1, 2, 40, 40).astype(np.float32)
  vol = InMemoryVolume(data, fill_value=0.0)

  class Doubler(runner.SubvolumeProcessor):

    def process(self, subvol):
      return runner.Subvolume(subvol.data * 2, subvol.bbox)

  out_path = f'{workdir}/out'
  if proc_id == 0:
    TensorStoreVolume.create(out_path, (1, 2, 40, 40), np.float32,
                             chunk_size=(1, 1, 16, 16))
  distributed.barrier('created')
  out_vol = TensorStoreVolume.open(out_path)

  distributed.process_volume_distributed(
      Doubler(), vol, output_volume=out_vol, subvolume_size=(16, 16, 2))

  if proc_id == 0:
    result = out_vol[(slice(None),) * 4]
    np.testing.assert_allclose(result, data * 2, atol=1e-6)
    print('DISTRIBUTED_OK', flush=True)


def run_flow(coordinator, num_procs, proc_id, workdir):
  import jax
  import numpy as np
  from jax.sharding import Mesh
  from sofima_tpu import flow_field
  from sofima_tpu.parallel import distributed, mesh_sharding
  from sofima_tpu.processor import flow as flow_proc
  from sofima_tpu.processor import runner
  from sofima_tpu.processor.defaults import em_2d
  from sofima_tpu.utils import metrics
  from sofima_tpu.utils.volume import InMemoryVolume, TensorStoreVolume

  distributed.initialize(coordinator_address=coordinator,
                         num_processes=num_procs, process_id=proc_id)
  assert distributed.process_count() == num_procs

  # Shared input: every host reads the same deterministic stack (stands
  # in for shared TensorStore/GCS input).
  n = 360
  tex = _texture(n)
  stack = np.stack([np.roll(tex, 2 * z, axis=1) for z in range(3)])
  vol = InMemoryVolume(stack[None], fill_value=0.0)

  cfg = em_2d.estimate_flow_config({'patch_size': 80, 'stride': 40,
                                    'batch_size': 64})
  proc = flow_proc.EstimateFlow(cfg)

  out_size, channels = runner.output_geometry(proc, vol.meta)
  out_path = f'{workdir}/flow_out'
  if proc_id == 0:
    TensorStoreVolume.create(
        out_path, (channels,) + out_size[::-1], np.float32,
        chunk_size=(1, 1, 3, 3))
  distributed.barrier('flow-out-created')
  out_vol = TensorStoreVolume.open(out_path)

  # --- Stage 1: cross-host chunk DP over the EstimateFlow grid. ---------
  t0 = time.time()
  distributed.process_volume_distributed(
      proc, vol, output_volume=out_vol, subvolume_size=(240, 240, 3))
  flow_s = time.time() - t0

  # --- Stage 2: intra-host spatially-sharded dense flow (local mesh). ---
  local = np.array(jax.local_devices())[:2]
  assert local.size == 2, f'need 2 local devices, got {local!r}'
  lmesh = Mesh(local, ('mesh_y',))
  strip = 16
  pre_s = tex[:strip * 2 * 2, :48]
  post_s = np.roll(pre_s, (1, -1), (0, 1))
  t0 = time.time()
  sharded = np.asarray(mesh_sharding.dense_flow_field_sharded(
      lmesh, pre_s, post_s, (16, 16), (8, 8), batch_size=16))
  ref = np.asarray(flow_field.dense_flow_field(
      pre_s, post_s, (16, 16), (8, 8), batch_size=16))
  np.testing.assert_allclose(sharded, ref, atol=1e-3, equal_nan=True)
  sharded_s = time.time() - t0

  with open(f'{workdir}/host{proc_id}.json', 'w') as f:
    json.dump({
        'host': proc_id,
        'chunk_dp_s': round(flow_s, 3),
        'sharded_dense_flow_s': round(sharded_s, 3),
        'subvolumes_done': metrics.registry().get_counter(
            'EstimateFlow', 'subvolumes-done'),
    }, f)

  distributed.barrier('flow-done')

  if proc_id == 0:
    flow = out_vol[(slice(None),) * 4]
    # Sections 1..2 must carry flow -2 (content rolled +2/section).
    interior = flow[0, 1:, 2:-2, 2:-2]
    valid = np.isfinite(interior)
    assert valid.any(), 'no valid flow assembled'
    assert np.nanmedian(interior[valid]) == -2.0
    # Both hosts contributed chunks.
    counts = []
    for i in range(num_procs):
      with open(f'{workdir}/host{i}.json') as f:
        counts.append(json.load(f)['subvolumes_done'])
    assert all(c > 0 for c in counts), counts
    print('DISTRIBUTED_FLOW_OK', json.dumps(counts), flush=True)


def main():
  coordinator, num_procs, proc_id, workdir = sys.argv[1:5]
  mode = sys.argv[5] if len(sys.argv) > 5 else 'double'
  _setup()
  if mode == 'double':
    run_double(coordinator, int(num_procs), int(proc_id), workdir)
  elif mode == 'flow':
    run_flow(coordinator, int(num_procs), int(proc_id), workdir)
  else:
    raise ValueError(mode)


if __name__ == '__main__':
  main()
