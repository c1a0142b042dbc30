"""Subvolume: a chunk of voxel data anchored in a global coordinate system.

Minimal equivalent of `connectomics.volume.subvolume.Subvolume`
as used by the reference processor layer
(/root/reference/processor/flow.py:150-245).
Data layout is channel-first [c, z, y, x]; the bounding box is XYZ.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sofima_tpu.utils.bounding_box import BoundingBox


@dataclasses.dataclass
class Subvolume:
  """A [c, z, y, x] array + the XYZ bounding box it was extracted from."""

  data: np.ndarray
  bbox: BoundingBox

  def __post_init__(self):
    if self.data.ndim == 3:
      self.data = self.data[np.newaxis, ...]
    if self.data.ndim != 4:
      raise ValueError(f'Subvolume data must be [c,z,y,x], got '
                       f'{self.data.shape}')
    expected = tuple(int(v) for v in self.bbox.size[::-1])
    if self.data.shape[1:] != expected:
      raise ValueError(f'data shape {self.data.shape[1:]} does not match '
                       f'box size (zyx) {expected}')

  @property
  def shape(self):
    return self.data.shape

  @property
  def num_channels(self) -> int:
    return self.data.shape[0]

  def split_channels(self) -> list['Subvolume']:
    return [Subvolume(self.data[i:i + 1], self.bbox)
            for i in range(self.num_channels)]

  def clip(self, box: BoundingBox) -> 'Subvolume':
    """Returns the part of this subvolume within `box`."""
    isec = self.bbox.intersection(box)
    if isec is None:
      raise ValueError(f'No intersection between {self.bbox} and {box}')
    rel = isec.translate(-self.bbox.start)
    return Subvolume(self.data[rel.to_slice4d()], isec)
