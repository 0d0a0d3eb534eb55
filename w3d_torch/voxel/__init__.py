"""Voxel engine (port of `3dworld_tpu/voxel/`): 3-D density fields,
isosurface extraction, ambient occlusion, realtime edits and collision."""
from . import grid     # noqa: F401
from . import mc       # noqa: F401
from . import mc256    # noqa: F401
from . import edit     # noqa: F401
from . import ao       # noqa: F401
from . import collide  # noqa: F401
