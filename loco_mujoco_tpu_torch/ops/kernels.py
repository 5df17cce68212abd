"""Build, load and count the port's hand-written Hopper kernels.

Each `csrc/<name>.cu` holds `extern "C"` launchers with a plain C interface.
It is compiled by `nvcc` for `sm_90a` into a shared library under
`build/torch_kernels/` at first use, and loaded with ctypes (no PyTorch
headers, so a build takes seconds, and no `ninja`). A library's file name
carries a hash of its source, the shared headers (`csrc/*.cuh`) and its
flags, so an edited source is rebuilt and a stale library is never
loaded. `build_all()` starts one `nvcc` per library, all at once.

Two nv widths are compiled (`NV_WIDTHS`): every source at the first, 24,
with no macro, and the sources whose local arrays or lanes hold nv
(`WIDE`: the Newton kernel, the fused kernel and the mega kernels) a
second time at 32 (`-DLMT_NVM=32`, `width_defines`). A wrapper loads the
library of the width its model needs (`nv_width`).

Every launcher returns `cudaGetLastError()` after its launch; `check()`
raises on a non-zero code. `LAUNCHES` counts, per kernel name, the launches
the wrappers made; a wrapper adds one where it launches and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("layout", "newton", "plane_mesh", "mega", "fused")
# the collision kernels mirror their plain versions' operation order
# (no fused multiply-add), so both pick the same argmin vertex and the
# same active contacts; mega.cu unfuses its collision functions itself
# (__fmul_rn / __fadd_rn) and keeps contraction elsewhere
_EXTRA_FLAGS = {"plane_mesh": ["--fmad=false"]}
# the compiled nv widths (csrc LMT_NVM; ops/plan.py NV_WIDTHS) and the
# sources built again at each width past the first
NV_WIDTHS = (24, 32)
WIDE = ("newton", "fused", "mega")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict = {}


def build_dir() -> Path:
    """`build/torch_kernels/` at the root of the checkout."""
    return CSRC.parent.parent / "build" / "torch_kernels"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA "
                           "toolkit")
    return path


def _label(name: str, defines=()) -> str:
    return "-".join([name, *(d.lower() for d in defines)])


def _target(name: str, defines=()) -> tuple[Path, list]:
    src = CSRC / f"{name}.cu"
    flags = (_FLAGS + _EXTRA_FLAGS.get(name, [])
             + [f"-D{d}" for d in defines])
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode())
    so = f"{_label(name, defines)}-{digest.hexdigest()[:12]}.so"
    return build_dir() / so, flags


def nv_width(nv: int):
    """The narrowest compiled width that holds nv dofs, or None."""
    return next((w for w in NV_WIDTHS if nv <= w), None)


def width_defines(width: int) -> tuple:
    """The macros of the libraries compiled at nv width `width`."""
    return () if width == NV_WIDTHS[0] else (f"LMT_NVM={width}",)


def libraries(names=SOURCES, defines=()) -> list:
    """(name, macros) of every library of `names`: each at the first
    width, and those of `WIDE` at every width past it, all with the
    macros `defines` besides."""
    return ([(n, tuple(defines)) for n in names]
            + [(n, width_defines(w) + tuple(defines))
               for w in NV_WIDTHS[1:] for n in names if n in WIDE])


def build_all(names=SOURCES, defines=()) -> float:
    """Compile every missing library of `libraries(names, defines)`."""
    return _build(libraries(names, defines))


def _build(targets) -> float:
    """Compile the missing libraries of `targets` ((name, macros) each),
    one `nvcc` per library in parallel. Returns the seconds spent; raises
    with the compiler's output on a failed build. `-Xptxas -v` (registers,
    spills) goes to `<label>.ptxas` (`ptxas_log`)."""
    t0 = time.perf_counter()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for name, defines in targets:
        so, flags = _target(name, defines)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, defines, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, defines, so, tmp, proc in procs:
        out, _ = proc.communicate()
        ptxas_log(name, defines).write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc {_label(name, defines)} failed:\n{out}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def ptxas_log(name: str, defines=()) -> Path:
    """The `-Xptxas -v` output of a library's last build."""
    return build_dir() / f"{_label(name, defines)}.ptxas"


def library(name: str, signatures: dict, defines=()) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` (compiled with the macros
    `defines`), built first if missing. `signatures` maps each launcher to
    its argtypes; every launcher returns an int CUDA error code. Every
    launch asks for it, so a loaded library is found by one lookup of
    (name, defines)."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        so, _ = _target(name, defines)
        if not so.exists():
            _build([(name, tuple(defines))])
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[key] = lib
    return lib


INT = ctypes.c_int
FLOAT = ctypes.c_float
PTR = ctypes.c_void_p


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream() -> int:
    """The handle of PyTorch's current stream on the current device, as
    the int a launcher's `stream` argument (argtypes `PTR`) takes: the raw
    handle, as PyTorch's own generated code reads it, since
    `torch.cuda.current_stream()` builds a Stream object per call, which
    costs more host time than a small launch."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def ptr(t: torch.Tensor) -> int:
    """A tensor's address, as the int a `PTR` argument takes."""
    return t.data_ptr()


def require(t: torch.Tensor, name: str, shape, dtype=torch.float32) -> None:
    """Validate a kernel operand: CUDA, dtype, exact shape, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.shape != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
