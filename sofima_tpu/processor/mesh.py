"""Serial-section mesh-relaxation processor.

Capability parity with /root/reference/processor/mesh.py: blockwise
sequential alignment of a section stack. Each work item optimizes one
section against reference ('prev') node positions obtained by composing
inter-section flows with already-solved reference meshes; supports
multi-Δz flow averaging (Hooke linearity), skipped sections/ranges with
bridging flows, coming-in regions with multi-z flows, irregular-node
masking, PREV_MEDIAN initialization, and the fold-recovery re-solve
protocol (solve -> check folds -> re-solve from fresh init with k0/10 ->
final solve), using the fused on-device relaxation loop.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
from typing import Any, Sequence

import jax.numpy as jnp
import numpy as np

from sofima_tpu import flow_utils
from sofima_tpu import map_utils
from sofima_tpu import mesh as mesh_lib
from sofima_tpu.processor import client_utils
from sofima_tpu.processor.base import SubvolumeProcessor
from sofima_tpu.utils.bounding_box import BoundingBox
from sofima_tpu.utils.subvolume import Subvolume


class SolutionStatus(enum.IntEnum):
  UNDEFINED = -1
  REGULAR = 0
  PREP_FAILED = 1
  REGULARIZED = 2


class MeshInitState(enum.Enum):
  ZEROS = 0
  PREV_MEDIAN = 1


@dataclasses.dataclass(frozen=True)
class FlowVolume:
  delta_z: int
  volume: Any


@dataclasses.dataclass(frozen=True)
class BadSectionRange:
  """[start, end] sections to skip, bridged by a dedicated flow volume.

  Forward: the flow at z = end + 1 holds estimates between end + 1 (post)
  and start - 1 (pre). Backward: at z = start - 1, between start - 1
  (post) and end + 1 (pre).
  """

  start: int
  end: int
  flow: FlowVolume


@dataclasses.dataclass(frozen=True)
class MeshOptions:
  init_state: MeshInitState = MeshInitState.ZEROS
  irregular_mask_radius: int | None = None


@dataclasses.dataclass(frozen=True)
class ComingIn:
  """First full section after a coming-in region + its multi-z flow."""

  z: int
  flow: Any


class RelaxMesh(SubvolumeProcessor):
  """Relaxes the mesh of one section per work item."""

  @dataclasses.dataclass(eq=True)
  class Config:
    output_dir: str
    integration_config: mesh_lib.IntegrationConfig
    mesh: Any = None                     # prior mesh volume (init/reference)
    flows: list[FlowVolume] = dataclasses.field(default_factory=list)
    sections_to_skip: list[int] = dataclasses.field(default_factory=list)
    ranges_to_skip: list[BadSectionRange] = dataclasses.field(
        default_factory=list)
    mask: Any = None
    block_starts: list[int] = dataclasses.field(default_factory=list)
    block_ends: list[int] = dataclasses.field(default_factory=list)
    backward: bool = False
    mesh_min_frac: float = 0.5
    mesh_max_frac: float = 1.75
    coming_in: list[ComingIn] = dataclasses.field(default_factory=list)
    options: MeshOptions = dataclasses.field(default_factory=MeshOptions)

  def __init__(self, config: 'RelaxMesh.Config', input_ts_spec=None):
    del input_ts_spec
    self._config = config

  # -- Reference-state assembly -------------------------------------------
  def is_skipped_section(self, z: int) -> bool:
    config = self._config
    if z in config.sections_to_skip:
      return True
    return any(rng.start <= z <= rng.end for rng in config.ranges_to_skip)

  def compute_ref_mesh(self, flow: np.ndarray, ref_box: BoundingBox,
                       stride: Sequence[float]) -> np.ndarray:
    """Composes a flow with the solved mesh of its reference section."""
    config = self._config
    ref_mesh = self._load_stitched_tile(config.output_dir, ref_box)
    if ref_mesh is None:
      assert config.mesh is not None
      ref_mesh = self._open_volume(config.mesh)[ref_box.to_slice4d()]

    if config.mask is not None:
      mask = self._build_mask(config.mask, ref_box)
      flow_utils.apply_mask(ref_mesh, mask)

    return np.array(map_utils.compose_maps_fast(
        jnp.asarray(np.asarray(flow, np.float32)),
        np.asarray(ref_box.start)[::-1].astype(np.float32), tuple(stride),
        jnp.asarray(np.asarray(ref_mesh, np.float32)),
        np.asarray(ref_box.start)[::-1].astype(np.float32), tuple(stride)))

  def compute_ref_mesh_multiz(self, flow: np.ndarray, box: BoundingBox,
                              starts: Sequence[int],
                              stride: Sequence[float],
                              ignore_xblock: bool = True,
                              allow_missing_mesh: bool = True) -> np.ndarray:
    """Reference state from a 3-channel (multi-Δz) flow volume."""
    config = self._config
    z_offsets = np.unique(flow[2, 0])
    z_offsets = z_offsets[np.isfinite(z_offsets) & (z_offsets != 0)]
    z_offsets = z_offsets.astype(np.int32).tolist()
    state = np.full([2] + list(flow.shape[1:]), np.nan)

    z = int(box.start[2])
    curr_block = client_utils.get_block_id(z, starts, config.backward)
    for delta_z in sorted(z_offsets, key=abs):
      ref_block = client_utils.get_block_id(z - delta_z, starts,
                                            config.backward)
      if curr_block != ref_block:
        if ignore_xblock:
          break
        raise ValueError(
            f'Mesh data must stay within one block ({z} vs {z - delta_z}).')

      ref_box = box.translate((0, 0, -delta_z))
      ref_mesh = self._load_stitched_tile(config.output_dir, ref_box)
      if ref_mesh is None:
        if allow_missing_mesh:
          assert config.mesh is not None
          ref_mesh = self._open_volume(config.mesh)[ref_box.to_slice4d()]
        else:
          raise ValueError(f'Missing mesh data for {ref_box.start}')

      if config.mask is not None:
        mask = self._build_mask(config.mask, ref_box)
        flow_utils.apply_mask(ref_mesh, mask)

      m = flow[2] == delta_z
      curr_flow = flow[:2].copy()
      curr_flow[0][~m] = np.nan
      curr_flow[1][~m] = np.nan

      composed = np.array(map_utils.compose_maps_fast(
          jnp.asarray(curr_flow.astype(np.float32)),
          np.asarray(box.start)[::-1].astype(np.float32), tuple(stride),
          jnp.asarray(np.asarray(ref_mesh, np.float32)),
          np.asarray(box.start)[::-1].astype(np.float32), tuple(stride)))
      state[0][m] = composed[0][m]
      state[1][m] = composed[1][m]

    return state

  def get_prev_state(self, stride: Sequence[float],
                     bbox: BoundingBox) -> np.ndarray | None:
    """Reference node positions for the section at bbox (or None)."""
    config = self._config
    z = int(bbox.start[2])
    starts = sorted(config.block_starts)
    if z in starts:
      return None  # block-start sections are pinned, not optimized

    for cin in config.coming_in:
      if z == cin.z:
        flow = self._open_volume(cin.flow)[bbox.to_slice4d()]
        return self.compute_ref_mesh_multiz(
            flow, bbox, starts, stride, ignore_xblock=False,
            allow_missing_mesh=False)

    flows = config.flows
    prev_z = z - (-1 if config.backward else 1)
    for rng in config.ranges_to_skip:
      if prev_z == rng.end:
        flows = [rng.flow]
        break

    curr_block = client_utils.get_block_id(z, starts, config.backward)
    prev = np.zeros((2, 1, int(bbox.size[1]), int(bbox.size[0])))
    count = np.zeros((int(bbox.size[1]), int(bbox.size[0])), np.int32)
    num_refs = 0
    for flow_spec in flows:
      ref_z = z - flow_spec.delta_z
      if self.is_skipped_section(ref_z):
        continue
      if client_utils.get_block_id(ref_z, starts,
                                   config.backward) != curr_block:
        continue

      vol = self._open_volume(flow_spec.volume)
      flow = vol[bbox.to_slice4d()]
      if vol.meta.num_channels == 2:
        ref_box = bbox.translate((0, 0, -flow_spec.delta_z))
        ref_mesh = self.compute_ref_mesh(flow, ref_box, stride)
      else:
        ref_mesh = self.compute_ref_mesh_multiz(flow, bbox, starts, stride)

      count += np.isfinite(ref_mesh[0, 0]).astype(np.int32)
      prev += np.nan_to_num(ref_mesh)
      num_refs += 1

    if num_refs == 0:
      return None

    # Average the references (valid by Hooke linearity).
    count = count.astype(np.float32)
    count[count == 0] = np.nan
    prev = prev / count[np.newaxis, np.newaxis]

    mask_radius = 1
    if config.options and config.options.irregular_mask_radius is not None:
      mask_radius = config.options.irregular_mask_radius
    map_utils.mask_irregular(prev[:, 0], stride, config.mesh_min_frac,
                             config.mesh_max_frac,
                             dilation_iters=mask_radius)
    return prev

  # -- Initial state -------------------------------------------------------
  def maybe_update_init_state(self, x: np.ndarray,
                              prev: np.ndarray | None,
                              options: MeshOptions) -> np.ndarray:
    if options.init_state == MeshInitState.PREV_MEDIAN and prev is not None:
      x[0] = np.nanmedian(prev[0])
      x[1] = np.nanmedian(prev[1])
      x = np.nan_to_num(x)
    return x

  def get_mesh_state(self, box: BoundingBox, stride: Sequence[float],
                     prev: np.ndarray | None) -> np.ndarray:
    config = self._config
    if config.mesh is None:
      return np.zeros((2, 1, int(box.size[1]), int(box.size[0])))

    state = self._open_volume(config.mesh)[box.to_slice4d()]
    state = np.array(state, np.float32)
    masked = map_utils.mask_irregular(
        state[:, 0], stride, config.mesh_min_frac, config.mesh_max_frac,
        dilation_iters=0)
    if masked.any():
      state = np.zeros((2, 1, int(box.size[1]), int(box.size[0])))
      state = self.maybe_update_init_state(state, prev, config.options)
    return state

  # -- Relaxation with fold recovery --------------------------------------
  def relax_mesh(self, x: np.ndarray, prev: np.ndarray | None,
                 integration_config: mesh_lib.IntegrationConfig,
                 mask: np.ndarray | None
                 ) -> tuple[np.ndarray, list[float], int, SolutionStatus]:
    """Solves one section; re-solves with a softened data term on folds."""
    config = self._config
    if mask is not None:
      flow_utils.apply_mask(x, mask)

    x, e_kin, num_steps = mesh_lib.relax_mesh(
        jnp.asarray(np.asarray(x, np.float32)),
        None if prev is None else jnp.asarray(
            np.asarray(prev, np.float32)),
        integration_config)
    x = np.array(x)
    orig_x = x.copy()

    masked = map_utils.mask_irregular(
        x[:, 0], integration_config.stride, config.mesh_min_frac,
        dilation_iters=5)
    if not masked.any():
      return x, e_kin, num_steps, SolutionStatus.REGULAR

    logging.info('Folds detected; re-solving with k0/10 regularization.')
    start_x = np.zeros_like(x)
    start_x = self.maybe_update_init_state(start_x, prev, config.options)
    x, _, prep_steps = mesh_lib.relax_mesh(
        jnp.asarray(start_x.astype(np.float32)),
        jnp.asarray(x.astype(np.float32)),
        dataclasses.replace(integration_config,
                            k0=integration_config.k0 / 10.0))
    x = np.array(x)
    masked = map_utils.mask_irregular(
        x[:, 0], integration_config.stride, config.mesh_min_frac)
    if masked.any():
      return orig_x, e_kin, num_steps + prep_steps, SolutionStatus.PREP_FAILED

    if mask is not None:
      flow_utils.apply_mask(x, mask)
    x, e_kin2, reg_steps = mesh_lib.relax_mesh(
        jnp.asarray(x.astype(np.float32)),
        None if prev is None else jnp.asarray(prev.astype(np.float32)),
        integration_config)
    return (np.array(x), e_kin2, num_steps + prep_steps + reg_steps,
            SolutionStatus.REGULARIZED)

  def run_relaxation(self, bbox: BoundingBox
                     ) -> tuple[np.ndarray, list[float], int, SolutionStatus]:
    config = self._config
    z = int(bbox.start[2])
    e_kin: list[float] = []
    num_steps = 0
    status = SolutionStatus.UNDEFINED
    integration_config = config.integration_config
    prev = mask = None

    if z not in config.block_starts:
      if config.mask is not None:
        mask = self._build_mask(config.mask, bbox)
      prev = self.get_prev_state(integration_config.stride, bbox)

    x = self.get_mesh_state(bbox, integration_config.stride, prev)

    if (z not in config.block_starts and not np.all(np.isnan(x))
        and prev is not None and not np.all(np.isnan(prev))):
      x, e_kin, num_steps, status = self.relax_mesh(
          x, prev, integration_config, mask)
    return x, e_kin, num_steps, status

  def process(self, subvol: Subvolume) -> Subvolume:
    x, *_ = self.run_relaxation(subvol.bbox)
    return Subvolume(x, subvol.bbox)
