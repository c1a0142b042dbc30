"""Multi-process scale validation: 1/2/4/8-host distributed pipeline.

Runs the distributed flow stage (cross-host chunk DP + intra-host
sharded dense flow; tests/distributed_worker.py 'flow' mode) at
increasing process counts, checks output totals agree across all
counts, and reports the work partition per host.

Every worker pins itself to the CPU (tests/distributed_worker.py), so
the processes never compete for an accelerator: a JAX process reserves
most of a GPU's memory when it first touches it, and one card holds one
such process. The "hosts" time-share the machine's cores, so wall-clock
numbers cannot demonstrate speedup — this script validates CORRECTNESS
and partition balance at scale.

Run: python examples/scaling_multiprocess.py [--max-procs 8]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def run_at(n_procs: int, workdir: str) -> dict:
  with socket.socket() as s:
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
  coordinator = f'localhost:{port}'
  worker = os.path.join(os.path.dirname(__file__), '..', 'tests',
                        'distributed_worker.py')
  env = dict(os.environ)
  env.pop('XLA_FLAGS', None)
  procs = [
      subprocess.Popen(
          [sys.executable, worker, coordinator, str(n_procs), str(i),
           workdir, 'flow'],
          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
          env=env)
      for i in range(n_procs)
  ]
  outs = [p.communicate(timeout=900)[0] for p in procs]
  assert all(p.returncode == 0 for p in procs), outs
  assert 'DISTRIBUTED_FLOW_OK' in outs[0], outs[0][-2000:]
  hosts = []
  for i in range(n_procs):
    with open(os.path.join(workdir, f'host{i}.json')) as f:
      hosts.append(json.load(f))
  return {
      'n_procs': n_procs,
      'per_host_chunks': [h['subvolumes_done'] for h in hosts],
      'chunk_dp_s': max(h['chunk_dp_s'] for h in hosts),
  }


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument('--max-procs', type=int, default=8)
  args = parser.parse_args()

  rows = []
  n = 1
  while n <= args.max_procs:
    with tempfile.TemporaryDirectory() as wd:
      rows.append(run_at(n, wd))
      r = rows[-1]
      total = sum(r['per_host_chunks'])
      print(f"n_procs={n:>2}  chunks/host={r['per_host_chunks']}  "
            f"total={total}  wall_s={r['chunk_dp_s']:.1f}", flush=True)
    n *= 2

  totals = {sum(r['per_host_chunks']) for r in rows}
  assert len(totals) == 1, f'chunk totals diverged: {totals}'
  for r in rows:
    counts = r['per_host_chunks']
    assert max(counts) - min(counts) <= 1, f'unbalanced: {counts}'
  print('SCALING_VALIDATION_OK (totals equal, partitions balanced '
        f'up to {args.max_procs} processes)')
  return 0


if __name__ == '__main__':
  sys.exit(main())
