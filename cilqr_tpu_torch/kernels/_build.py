"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use by ``nvcc`` into one shared library
with a plain C interface, and loaded with ``ctypes``. The library lands in
``cilqr_tpu_torch/_build/``, named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads at once. Nothing here
runs at import: a machine without ``nvcc`` can import every module.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No --use_fast_math: the solver's accept/stop thresholds are chaotic, so
# the kernels keep IEEE division, sqrt and the accurate transcendentals.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double

# C signatures: name -> argtypes (every entry point returns int).
_SIGNATURES = {
    # T, B, KA, dt, wheel_base, lam, alpha, A, Bm, Jx, Ju, Hx, Hu, xs, us,
    # nxs, nus, Ks, ks, dv0, dv1, gnorm, stream
    "riccati_sweep": [_I, _I, _I, _D, _D] + [_P] * 17 + [_P],
    # N, B, KC, W, D, offs (host double[D]), bt, beps, want_derivs,
    # inputs (host array of 25 device pointers), out, stream
    "corridor_lane_stack": [_I, _I, _I, _I, _I, _P, _D, _D, _I, _P, _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcilqr_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the shared library unless it exists; returns
    its path. The compiler's report (registers, spills) is kept beside it
    as ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argtypes declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.cilqr_error_string.argtypes = [ctypes.c_int]
    lib.cilqr_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        text = library().cilqr_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err} ({text})")
