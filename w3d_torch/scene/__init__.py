"""Scene description (port of `3dworld_tpu/scene/`): coll-obj DSL parser,
scene assembly, model formats, skinning."""
from . import cobj  # noqa: F401
from . import model3d  # noqa: F401
from . import sphere_materials  # noqa: F401
from . import loader    # noqa: F401
from . import csg       # noqa: F401
from . import animation  # noqa: F401
from . import read_3ds   # noqa: F401
