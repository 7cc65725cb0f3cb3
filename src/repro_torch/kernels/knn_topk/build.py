"""Build and load the K-NN row-reduction CUDA kernel.

``nvcc`` compiles ``csrc/*.cu`` for ``sm_90a`` into a shared library with
a plain C interface, on first use, into ``build/kernels/`` at the root of
the checkout (or into ``$REPRO_TORCH_BUILD_DIR`` where that is set, as it
must be for an installed copy of the package).  The file name carries a hash of the sources and flags, so an
edited source builds anew and an unchanged one is reused.  The library is
loaded with ``ctypes``."""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_HERE = pathlib.Path(__file__).resolve().parent
_SOURCES = sorted((_HERE / "csrc").glob("*.cu"))
_ROOT = _HERE.parents[3]          # src/repro_torch/kernels/knn_topk -> root
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH)")
    return found


def build_dir() -> pathlib.Path:
    """``$REPRO_TORCH_BUILD_DIR`` if set, else ``build/kernels/`` in the
    checkout that holds this file.  Raises for an installed copy with no
    directory given, rather than writing next to ``site-packages``."""
    given = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if given:
        return pathlib.Path(given)
    if not (_ROOT / "pyproject.toml").is_file():
        raise RuntimeError(
            f"{_HERE} is not inside a checkout of the repo; set "
            "REPRO_TORCH_BUILD_DIR to a directory for the built kernels")
    return _ROOT / "build" / "kernels"


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"knn_topk-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources unless the library for their hash exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.knn_row_top2_regret
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib
