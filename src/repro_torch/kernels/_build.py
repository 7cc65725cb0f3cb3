"""Build and load the port's CUDA kernels.

Each kernel lives in ``kernels/<name>/csrc/*.cu`` and exports plain C
entry points.  ``nvcc`` compiles a kernel's sources for ``sm_90a`` into a
shared library, on first use, into ``build/kernels/`` at the root of the
checkout (or into ``$REPRO_TORCH_BUILD_DIR`` where that is set, as it must
be for an installed copy of the package).  The file name carries a hash
of the sources and flags, so an edited source builds anew and an
unchanged one is reused.  The library is loaded with ``ctypes``; each
kernel's ``ops.py`` declares the argument types of its entry points
(``c_void_p`` for pointers and the stream), so no pointer is cut to 32
bits.

``build_all`` starts one ``nvcc`` per kernel at once and waits for all."""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Iterable, Mapping, Sequence

_KERNELS = pathlib.Path(__file__).resolve().parent
_ROOT = _KERNELS.parents[2]           # src/repro_torch/kernels -> root
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# adds each kernel's registers, shared memory and spills to the build log;
# the binary is the same, so it is not part of the hash
VERBOSE_FLAGS = ("-Xptxas", "-v")

# C signature of an entry point: (argtypes, restype)
Signature = tuple[Sequence, object]

_libs: dict[str, ctypes.CDLL] = {}


def sources(name: str) -> list[pathlib.Path]:
    """The ``.cu`` files of kernel ``name``, sorted."""
    srcs = sorted((_KERNELS / name / "csrc").glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources in {_KERNELS / name / 'csrc'}")
    return srcs


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
            f"{_KERNELS} is not inside a checkout of the repo; set "
            "REPRO_TORCH_BUILD_DIR to a directory for the built kernels")
    return _ROOT / "build" / "kernels"


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str], verbose: bool = False) -> dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    each, all started together.  Returns the compiler's log per kernel
    built ("" for one that was already there); raises if any build fails."""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            procs[name] = None
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(VERBOSE_FLAGS if verbose else ()),
               "-o", str(tmp), *map(str, sources(name))]
        procs[name] = (cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, job in procs.items():
        if job is None:
            logs[name] = ""
            continue
        cmd, tmp, out, proc = job
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str, signatures: Mapping[str, Signature]) -> ctypes.CDLL:
    """Kernel ``name``'s loaded library, built first if needed, with the
    argument and return types of its entry points declared."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        _libs[name] = lib
    return lib
