"""World/scene constants (port of `3dworld_tpu/utils/constants.py`, the
fields and derived values the port uses).

The reference keeps these as mutable globals recomputed by
`set_scene_constants()` (matrix_ops.cpp:55-83) with defaults at
matrix_ops.cpp:9-24.  Here they are a frozen, hashable dataclass passed
explicitly to every function that needs grid geometry.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

# Defaults: matrix_ops.cpp:9-16
DEF_MESH_X_SIZE = 128
DEF_MESH_Y_SIZE = 128
DEF_MESH_Z_SIZE = 32
DEF_X_SCENE_SIZE = 4.0
DEF_Y_SCENE_SIZE = 4.0
DEF_Z_SCENE_SIZE = 4.0


@dataclasses.dataclass(frozen=True)
class WorldConst:
    """Scene-grid constants (reference: matrix_ops.cpp:55-83).

    Derived quantities are cached properties, so a `WorldConst` is cheap
    to pass around and hashable.
    """

    mesh_x: int = DEF_MESH_X_SIZE
    mesh_y: int = DEF_MESH_Y_SIZE
    mesh_z: int = DEF_MESH_Z_SIZE
    x_scene: float = DEF_X_SCENE_SIZE
    y_scene: float = DEF_Y_SCENE_SIZE
    z_scene: float = DEF_Z_SCENE_SIZE

    # --- derived (matrix_ops.cpp:59-82) ---
    @cached_property
    def mesh_height(self) -> float:
        return 0.10 * self.z_scene

    @cached_property
    def xy_scene(self) -> float:
        return 0.5 * (self.x_scene + self.y_scene)

    @cached_property
    def dx(self) -> float:
        return 2.0 * self.x_scene / self.mesh_x

    @cached_property
    def dy(self) -> float:
        return 2.0 * self.y_scene / self.mesh_y

    @cached_property
    def half_dxy(self) -> float:
        return 0.5 * (self.dx + self.dy)

    @cached_property
    def dxdy(self) -> float:
        return self.dx * self.dy

    @cached_property
    def dx_inv(self) -> float:
        return 1.0 / self.dx

    @cached_property
    def dy_inv(self) -> float:
        return 1.0 / self.dy


DEFAULT_WORLD = WorldConst()
