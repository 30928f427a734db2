"""Uniform grid partitions as pure index arithmetic.

The reference materializes a vector of grid-item objects
(reference ``image/partition2.hpp:109-135``).  Here a uniform grid is
just arithmetic on a row-major item index, so we only ever build small numpy
origin arrays at trace time (static shapes), never device-side object lists.

Reference traversal parity: ``createUniformGrid`` scans row-major with stride
``itemOffset`` and keeps every origin with ``origin + itemSize <= imageSize``
(``partition2.hpp:123-133``).  Overlapping domain grids are expressed by
``itemOffset < itemSize`` exactly as in the reference (e.g. 16x16 blocks at
step 8 = 50% overlap).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = ["Grid", "uniform_grid", "grid_count_1d"]


def grid_count_1d(image_extent: int, item_size: int, step: int) -> int:
    """Number of grid positions along one axis."""
    if image_extent < item_size:
        return 0
    return (image_extent - item_size) // step + 1


@dataclasses.dataclass(frozen=True)
class Grid:
    """A uniform square-block grid over a height x width image plane.

    Item order is row-major (x fastest), matching the reference scan
    (``partition2.hpp:123-133``).
    """

    width: int
    height: int
    block_size: int
    step: int

    @property
    def nx(self) -> int:
        return grid_count_1d(self.width, self.block_size, self.step)

    @property
    def ny(self) -> int:
        return grid_count_1d(self.height, self.block_size, self.step)

    @property
    def num_items(self) -> int:
        return self.nx * self.ny

    def origins(self) -> tuple[np.ndarray, np.ndarray]:
        """(origin_x, origin_y), each [num_items] int32, row-major order."""
        xs = np.arange(self.nx, dtype=np.int32) * self.step
        ys = np.arange(self.ny, dtype=np.int32) * self.step
        ox = np.tile(xs, self.ny)
        oy = np.repeat(ys, self.nx)
        return ox, oy

    def flat_origins(self, stride: int | None = None) -> np.ndarray:
        """[num_items] flat index of each block's top-left pixel."""
        if stride is None:
            stride = self.width
        ox, oy = self.origins()
        return (oy.astype(np.int64) * stride + ox).astype(np.int32)


@functools.lru_cache(maxsize=None)
def uniform_grid(width: int, height: int, block_size: int, step: int) -> Grid:
    return Grid(width=width, height=height, block_size=block_size, step=step)
