"""Multi-host execution utilities.

The reference scales out through an external Beam service; this module is
the framework-native equivalent for multi-host accelerator jobs:

  * `initialize()` — wraps jax.distributed.initialize for multi-host
    runs (controller-less; coordinator address from the environment).
  * `partition_work()` — deterministic round-robin assignment of
    processor work boxes to hosts (idempotent chunk jobs, so failure
    recovery = rerun missing chunks, matching the reference's model).
  * `process_volume_distributed()` — each host runs its share of the
    chunk grid with the local runner; results land in a shared output
    volume (TensorStore on shared storage in production, in-memory for
    single-host tests), followed by an optional cross-host barrier.
  * `device_mesh()` — builds 1d/2d jax.sharding.Mesh over all devices of
    the job for the spatially-sharded solver (in `jax.devices()` order;
    the collectives go to NCCL on GPUs).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from sofima_tpu.processor import runner as runner_lib
from sofima_tpu.utils.bounding_box import BoundingBox


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
  """Initializes jax.distributed (no-op for single-process jobs)."""
  import jax
  if num_processes is None:
    num_processes = int(os.environ.get('SOFIMA_NUM_PROCESSES', '1'))
  if num_processes <= 1:
    return
  if process_id is None:
    process_id = int(os.environ.get('SOFIMA_PROCESS_ID', '0'))
  if coordinator_address is None:
    coordinator_address = os.environ.get('SOFIMA_COORDINATOR',
                                         'localhost:8476')
  jax.distributed.initialize(coordinator_address=coordinator_address,
                             num_processes=num_processes,
                             process_id=process_id)


def process_count() -> int:
  import jax
  return jax.process_count()


def process_index() -> int:
  import jax
  return jax.process_index()


def device_mesh(axis_names: Sequence[str] = ('mesh_y',),
                shape: Sequence[int] | None = None):
  """Mesh over all job devices (all hosts), default 1d."""
  import jax
  from jax.sharding import Mesh
  devices = np.array(jax.devices())
  if shape is not None:
    devices = devices[:int(np.prod(shape))].reshape(shape)
  return Mesh(devices, tuple(axis_names))


def partition_work(work_boxes: Sequence[BoundingBox],
                   num_parts: int | None = None,
                   part_index: int | None = None) -> list[BoundingBox]:
  """Deterministic round-robin share of the chunk grid for this host."""
  if num_parts is None:
    num_parts = process_count()
  if part_index is None:
    part_index = process_index()
  return [b for i, b in enumerate(work_boxes)
          if i % num_parts == part_index]


def barrier(name: str = 'sofima-barrier') -> None:
  """Cross-host synchronization point (psum over all devices)."""
  import jax
  if jax.process_count() == 1:
    return
  from jax.experimental import multihost_utils
  multihost_utils.sync_global_devices(name)


def process_volume_distributed(processor, input_volume,
                               output_volume=None,
                               subvolume_size=None,
                               parallelism: int = 1):
  """Runs a processor's chunk grid, split across hosts.

  Each host processes `work_boxes[i] for i % num_hosts == host_id`; the
  output volume must be shared storage (TensorStore) for multi-host runs.
  Returns this host's output volume handle.
  """
  from sofima_tpu.utils.box_generator import BoxGenerator
  from sofima_tpu.utils.volume import open_volume

  vol = open_volume(input_volume)
  pre, post = processor.context()
  overlap = np.array(processor.overlap(), np.int64)
  if subvolume_size is None:
    suggested = np.array(tuple(processor.subvolume_size()), np.int64)
  else:
    suggested = np.array(subvolume_size, np.int64)
  vol_size = np.array(vol.meta.volume_size, np.int64)
  work_size = np.minimum(suggested, vol_size + overlap)
  outer = BoundingBox(
      start=(-np.array(pre)).tolist(),
      size=(vol_size + np.array(pre) + np.array(post)).tolist())
  gen = BoxGenerator(outer, box_size=work_size, box_overlap=overlap,
                     back_shift_small_boxes=True)
  mine = partition_work(list(gen))

  out = runner_lib.process_volume(
      processor, vol, output_volume=output_volume,
      subvolume_size=subvolume_size, parallelism=parallelism,
      work_boxes=mine)
  barrier('process-volume-' + processor.namespace)
  return out
