"""Test configuration: run everything on a virtual 8-device CPU mesh.

The GPU is exercised separately (`python chip_smoke.py`, `bench.py`);
unit tests use XLA's host-platform device virtualization so multi-device
sharding logic (shard_map/pjit over a Mesh) is validated without an
accelerator. The CPU backend is forced both through the environment and
through jax.config, so a machine whose JAX defaults to a GPU still runs
the suite on the CPU.
"""

import os

flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
  os.environ['XLA_FLAGS'] = (
      flags + ' --xla_force_host_platform_device_count=8').strip()
os.environ['JAX_PLATFORMS'] = 'cpu'

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
