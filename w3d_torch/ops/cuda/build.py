"""Build and bind the port's hand-written CUDA kernels.

Each source under `w3d_torch/csrc/*.cu` compiles in its own `nvcc`
process, all started together, and the objects link into one shared
library with a plain C interface, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -Xcompiler -fPIC -c -o <obj> w3d_torch/csrc/<source>.cu   # per source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o w3d_torch/_build/libw3d_kernels_<hash>.so <objs>

The build happens at first use (never at import), into `w3d_torch/_build/`
(git-ignored), and the file name carries a hash of the sources and flags,
so an edited source rebuilds and an unchanged one loads the cached library.
`build(defines=...)` makes a variant library the same way
(`utils/kernel_probe` builds it with the erosion kernel's phase counters;
`Kernel.variant` binds an entry point of one).

`-fmad=false` stops `nvcc` from contracting `a*b+c` into one fused
multiply-add.  Every kernel then rounds each product and sum on its own,
as the plain PyTorch versions do op by op, which keeps the kernels
bit-comparable with them (mesh-sample heights and pair deltas are
compared at the last ulp).

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `Kernel.launch` raises on a nonzero code and counts
the launches, so a run can show that its main path went through the
kernel.  `Kernel.instances` holds every `Kernel` made, variants too: a
CUDA graph's capture (`graphs`) reads and restores their counts.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
import weakref

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-fmad=false",
                              "-Xcompiler", "-fPIC"]

_libs: dict[tuple[str, ...], ctypes.CDLL] = {}   # defines -> loaded library
build_seconds: float | None = None   # wall time of this process's build, if it built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path(flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libw3d_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; raise on the first that fails.
    Returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{o}")
    return "".join(outs)


def build(verbose: bool = False, defines: tuple[str, ...] = ()) -> str:
    """Compile the kernels unless the library for these sources and flags
    exists.  Returns the library path.  With `verbose`, `ptxas` prints each
    kernel's registers, shared memory and spills.  `defines` (names for
    `-D`) make a variant."""
    global build_seconds
    flags = COMPILE_FLAGS + [f"-D{d}" for d in defines]
    srcs = _sources()
    out = library_path(flags)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    t0 = time.perf_counter()
    try:
        log = _run_all([[_nvcc()] + flags + (["-Xptxas", "-v"] if verbose else [])
                        + ["-c", "-o", o, s] for s, o in zip(srcs, objs)])
        log += _run_all([[_nvcc()] + ARCH_FLAGS + ["-shared", "-o", tmp] + objs])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    if verbose:
        print(log)
    os.replace(tmp, out)     # atomic: a concurrent loader never sees half a file
    build_seconds = time.perf_counter() - t0
    return out


def library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded kernel library, or its variant built with `defines`
    (built on first call)."""
    if defines not in _libs:
        _libs[defines] = ctypes.CDLL(build(defines=defines))
    return _libs[defines]


class Kernel:
    """One C entry point of the library: binds its argument types, checks
    the returned CUDA error, and counts launches."""

    instances: "weakref.WeakSet[Kernel]" = weakref.WeakSet()

    def __init__(self, symbol: str, argtypes: list, defines: tuple[str, ...] = ()):
        self.symbol = symbol
        # every entry point ends with the stream and returns cudaError_t
        self.argtypes = list(argtypes)
        self.defines = defines
        self.launches = 0
        self._fn = None
        Kernel.instances.add(self)

    def variant(self, *defines: str) -> "Kernel":
        """The same entry point in the library built with `defines`, with
        its own launch count."""
        return Kernel(self.symbol, self.argtypes, defines)

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.defines), self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]   # the stream
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err}")
        self.launches += 1


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
