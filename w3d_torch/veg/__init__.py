"""Vegetation & scenery (port of `3dworld_tpu/veg/`): trees, grass,
rocks/logs/plants, animals."""
from . import trees    # noqa: F401
from . import grass    # noqa: F401
from . import scenery  # noqa: F401
from . import animals  # noqa: F401
