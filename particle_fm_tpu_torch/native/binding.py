"""ctypes binding to the port's jet clusterer, `native/cluster.cpp`;
counterpart of particle_fm_tpu/native/binding.py (same functions, same
results).

The library is built with g++ at first use into `build/native/` at the root
of the checkout, one shared library per version of the source (named by a
hash of its bytes), never beside the source; a failed build raises. Events
are independent, so each call splits them over threads: ctypes releases the
interpreter lock during the foreign call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "cluster.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]
MIN_EVENTS_PER_THREAD = 64

_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libfastjet_lite_{digest}.so"


def build() -> Path:
    """Compile the source unless its library exists; returns the library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(["g++", *CXXFLAGS, "-o", tmp, str(SOURCE)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE.name} failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.cluster_events.argtypes = [
        dp, dp, dp, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        dp, ip, ip, ctypes.c_int,
    ]
    lib.cluster_events.restype = None
    lib.exclusive_kt_axes_events.argtypes = [
        dp, dp, dp, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, dp, ip,
    ]
    lib.exclusive_kt_axes_events.restype = None
    lib.kt_split_scales_events.argtypes = [
        dp, dp, dp, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, dp,
    ]
    lib.kt_split_scales_events.restype = None
    _lib = lib
    return lib


def _ptr(a: np.ndarray):
    kind = ctypes.c_int if a.dtype == np.int32 else ctypes.c_double
    return a.ctypes.data_as(ctypes.POINTER(kind))


def _inputs(pt, eta, phi):
    return tuple(np.ascontiguousarray(a, np.float64) for a in (pt, eta, phi))


def _over_events(call, inputs, outputs) -> None:
    """call(*input slices, n_events, n_max, *output slices) over chunks of
    events, one thread each; every array's first axis is the event."""
    b, n = inputs[0].shape
    workers = max(1, min(len(os.sched_getaffinity(0)), b // MIN_EVENTS_PER_THREAD))
    bounds = np.linspace(0, b, workers + 1).astype(int)

    def run(lo, hi):
        call(*(_ptr(a[lo:hi]) for a in inputs), hi - lo, n, *(_ptr(a[lo:hi]) for a in outputs))

    if workers == 1:
        run(0, b)
        return
    with ThreadPoolExecutor(workers) as pool:
        for fut in [pool.submit(run, lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])]:
            fut.result()


def cluster_events(
    pt: np.ndarray,
    eta: np.ndarray,
    phi: np.ndarray,
    R: float = 1.0,
    p: float = -1.0,
    min_pt: float = 0.0,
    max_jets: int = 10,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cluster padded events (B, N) with the generalized-kt algorithm.

    p = -1 anti-kt, 0 C/A, 1 kt. Zero-pt entries are padding.
    Returns (jets (B, max_jets, [pt, y, phi, m]), n_jets (B,),
             const_jet (B, N) jet index per particle or -1).
    """
    lib = get_lib()
    inputs = _inputs(pt, eta, phi)
    b, n = inputs[0].shape
    jets = np.zeros((b, max_jets, 4), np.float64)
    njets = np.zeros(b, np.int32)
    const_jet = np.zeros((b, n), np.int32)

    def call(ppt, peta, pphi, nb, nmax, pjets, pnj, pconst):
        lib.cluster_events(ppt, peta, pphi, nb, nmax, R, p, min_pt, pjets, pnj, pconst,
                           max_jets)

    _over_events(call, inputs, (jets, njets, const_jet))
    return jets, njets, const_jet


def kt_split_scales(
    pt: np.ndarray, eta: np.ndarray, phi: np.ndarray, R: float = 1.0, n_scales: int = 2
) -> np.ndarray:
    """kt splitting scales per event: out[:, 0] = d12 (2->1 merge),
    out[:, 1] = d23, ... (sqrt of the exclusive-kt merge distance)."""
    lib = get_lib()
    inputs = _inputs(pt, eta, phi)
    out = np.zeros((inputs[0].shape[0], n_scales), np.float64)

    def call(ppt, peta, pphi, nb, nmax, pout):
        lib.kt_split_scales_events(ppt, peta, pphi, nb, nmax, R, n_scales, pout)

    _over_events(call, inputs, (out,))
    return out


def exclusive_kt_axes(
    pt: np.ndarray, eta: np.ndarray, phi: np.ndarray, R: float = 1.0, n_axes: int = 3
) -> tuple[np.ndarray, np.ndarray]:
    """WTA exclusive-kt axes per event for N-subjettiness.

    Returns (axes (B, n_axes, [y, phi]), n_axes_found (B,))."""
    lib = get_lib()
    inputs = _inputs(pt, eta, phi)
    b = inputs[0].shape[0]
    axes = np.zeros((b, n_axes, 2), np.float64)
    found = np.zeros(b, np.int32)

    def call(ppt, peta, pphi, nb, nmax, paxes, pfound):
        lib.exclusive_kt_axes_events(ppt, peta, pphi, nb, nmax, R, n_axes, paxes, pfound)

    _over_events(call, inputs, (axes, found))
    return axes, found
