"""Multi-device layer on `torch.distributed` (port of `3dworld_tpu/parallel/`):
the device mesh (`mesh`), a launcher for ranks on one host (`launch`), the
cross-rank halo exchange and shadow chain (`halo`) and the pair pass
across slab edges (`pairs`).  The sharded bake is `lighting/parallel`, the
sharded steps `models/terrain_model.make_sharded_tile_step`,
`models/physics_model.make_sharded_frame_step` and
`entry.make_sharded_combined_step`; `python -m w3d_torch.dryrun` drives
them all."""
from .mesh import Mesh, init_mesh, local_block, gather_leading, pad_to_multiple  # noqa: F401
