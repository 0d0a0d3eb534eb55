"""Procedural universe (port of `3dworld_tpu/universe/`): cells, galaxies,
systems, planets and their names, planet surfaces, asteroid fields, the
ship-defs parser, fleets and the full weapon model."""
from . import gen          # noqa: F401
from . import surface      # noqa: F401
from . import ships        # noqa: F401
from . import ship_config  # noqa: F401
