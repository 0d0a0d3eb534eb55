"""PyTorch + CUDA port of the `3dworld_tpu` engine (imported there as `w3d`).

The JAX package stays the reference; this package mirrors its layout
module for module (`ops/pallas/` becomes `ops/cuda/`, the CUDA sources live
in `csrc/`).  It imports `torch` and never `jax`: the host pieces it needs
(world constants, the reference LCG, scene packing) are carried here
rather than imported from the JAX package, whose `__init__` imports jax.

Conventions:

* plain functions on tensors; `nn.Module` only where state is held;
* every function that allocates takes an explicit `device`, every random
  draw an explicit `torch.Generator`;
* each hand-written kernel sits behind a wrapper in `ops/cuda/` that runs
  the plain PyTorch version for CPU tensors and the CUDA kernel for CUDA
  tensors (and raises rather than falling back).

Ported: every single-device module of the JAX package, from the combined
world step (`entry.combined_step`) and the three modes of `app.main` to
the full-world build, weather, model formats and textures; ROADMAP.md
lists what is left (the multi-device modules).
"""
