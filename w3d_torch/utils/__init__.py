"""Core utilities (port of `3dworld_tpu/utils/`): constants, RNG, config,
profiling, checkpointing, event journals."""
from . import constants  # noqa: F401
from . import rng        # noqa: F401
from . import config      # noqa: F401
from . import profiler    # noqa: F401
from . import checkpoint  # noqa: F401
from . import events      # noqa: F401
