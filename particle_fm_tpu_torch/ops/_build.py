"""Build and load the port's CUDA kernel libraries.

Each source under `csrc/` has a plain C interface. It is compiled with nvcc
for sm_90a at first use into `build/torch_kernels/` beside the package, one
shared library per version of the source (named by a hash of its bytes and
of the headers it may include: the `*.cuh` beside it, which the compiler
finds first, and `csrc/*.cuh`), and loaded with ctypes. The
compiler's report (registers, shared memory, spills) is kept beside the
library as `<name>.log`. `build_libraries` starts one nvcc per source, all
together, so several kernels build in the time of the slowest.

Each kernel entry point is also a `torch.library` custom op in the namespace
`OPS_NAMESPACE` (registered where its wrapper lives), so that `torch.export`
can trace a network through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"

OPS_NAMESPACE = "particle_fm"

_libs: dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: Path) -> Path:
    """Where the library of this version of `source` lives once built."""
    digest = hashlib.sha256(source.read_bytes())
    beside = sorted(source.resolve().parent.glob("*.cuh"))
    for header in beside + [h for h in sorted(CSRC_DIR.glob("*.cuh")) if h not in beside]:
        digest.update(header.read_bytes())
    digest = digest.hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build_libraries(sources: Sequence[Path]) -> list[Path]:
    """Compile every source that has no library yet, in parallel; returns the
    libraries' paths in the order of `sources`."""
    outs = [library_path(s) for s in sources]
    jobs = []
    for source, out in zip(sources, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [
            nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC_DIR), "-o", tmp,
            str(source),
        ]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((proc, tmp, out))
    failures = []
    for proc, tmp, out in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed ({proc.returncode}) for {out.name}:\n{stdout}\n{stderr}")
            continue
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs


def build_library(source: Path) -> Path:
    return build_libraries([source])[0]


def load_library(source: Path, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library built from `source`, loaded once per source path;
    `declare` sets the argtypes and restype of its entry points."""
    if source not in _libs:
        lib = ctypes.CDLL(str(build_library(source)))
        declare(lib)
        _libs[source] = lib
    return _libs[source]


def check_tensor(name: str, t: torch.Tensor, shape: tuple[int, ...], device: torch.device,
                 contiguous: bool = True, dtype: torch.dtype = torch.float32) -> None:
    """Raise unless `t` is a tensor of `dtype` (float32 or bfloat16) and
    `shape` on `device`, contiguous unless the caller checks its strides
    itself. A kernel takes its operands in the type it was written for: the
    wrappers pass the caller's type through and never cast."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
