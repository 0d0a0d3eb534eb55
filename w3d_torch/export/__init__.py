"""Export (port of `3dworld_tpu/export/`): heightmap images, textures,
map views."""
from . import heightmap_io  # noqa: F401
from . import textures  # noqa: F401
from . import map_view  # noqa: F401
