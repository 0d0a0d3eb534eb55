"""Lighting precompute (port of `3dworld_tpu/lighting/`): lmcell volumes,
the batched path tracer, the dense sweep solver, incremental platform and
dlight-group volumes, and building indirect lighting."""
from . import lmap            # noqa: F401
from . import trace           # noqa: F401
from . import dlights         # noqa: F401
from . import accum           # noqa: F401
from . import sweep           # noqa: F401
from . import building_indir  # noqa: F401
