"""sofima_tpu: a JAX framework for optical-flow-based image montaging
and alignment of large microscopy datasets.

Built in JAX/XLA (jit, shard_map) with the capability surface of google-research/sofima: patch-based masked
cross-correlation flow estimation, elastic spring-mesh relaxation,
coordinate-map algebra, dense warping/rendering, and tile stitching —
all as compiled device programs rather than host loops over CPU kernels.

Module map (see README.md):
  flow_field, flow_utils   — flow estimation and filtering
  mesh                     — elastic mesh solver (Verlet + FIRE)
  map_utils                — coordinate-map algebra
  warp                     — rendering / dense warping
  stitch_rigid/_elastic    — tile montage workflows
  ops                      — device kernels
  parallel                 — multi-chip / multi-host scaling
  processor, pipeline      — chunk-parallel scale-out + configs
  decorators               — lazy TensorStore views
  utils                    — geometry, volumes, config, metrics
  native                   — C++ host kernels
"""

__version__ = '0.1.0'

# Core modules are imported lazily by user code (import sofima_tpu.mesh
# etc.); keep the package root import light so volume-only workflows do
# not pay the JAX startup cost.
