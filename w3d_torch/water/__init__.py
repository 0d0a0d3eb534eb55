"""Water & weather (port of `3dworld_tpu/water/`): ripples, valley
flooding, smoke diffusion, snow, clouds."""
from . import ripples  # noqa: F401
from . import smoke    # noqa: F401
from . import valleys  # noqa: F401
from . import snow     # noqa: F401
from . import clouds   # noqa: F401
