"""Build and load the port's CUDA kernels.

Each kernel lives in ``kernels/<name>/csrc/``: ``*.cu`` sources that
export plain C entry points, and the headers (``*.cuh``, ``*.h``) they
include.  ``nvcc`` compiles a kernel's sources for ``sm_90a`` and links
them into a shared library, on first use, into ``build/kernels/`` at the
root of the checkout (or into ``$REPRO_TORCH_BUILD_DIR`` where that is
set, as it must be for an installed copy of the package).  The file name
carries a hash of every source and header and of the flags, so an edited
file builds anew and an unchanged kernel is reused.  The library is
loaded with ``ctypes``; each kernel's ``ops.py`` declares the argument
types of its entry points (``c_void_p`` for pointers and the stream), so
no pointer is cut to 32 bits.

``build_all`` starts one ``nvcc -c`` per source of every kernel at once,
waits for all, then links each kernel's objects."""
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
              "-Xcompiler", "-fPIC")
HEADER_SUFFIXES = (".cuh", ".h")
# adds each kernel's registers, shared memory and spills to the build log;
# the binary is the same, so it is not part of the hash
VERBOSE_FLAGS = ("-Xptxas", "-v")

# C signature of an entry point: (argtypes, restype)
Signature = tuple[Sequence, object]

_libs: dict[str, ctypes.CDLL] = {}


def sources(name: str) -> list[pathlib.Path]:
    """The ``.cu`` files of kernel ``name``, sorted: what ``nvcc`` compiles."""
    srcs = sorted((_KERNELS / name / "csrc").glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources in {_KERNELS / name / 'csrc'}")
    return srcs


def build_inputs(name: str) -> list[pathlib.Path]:
    """Every file the build of kernel ``name`` reads: its sources and the
    headers beside them, sorted."""
    csrc = _KERNELS / name / "csrc"
    headers = [p for p in csrc.iterdir() if p.suffix in HEADER_SUFFIXES]
    return sorted(sources(name) + headers)


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
    for src in build_inputs(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _run_all(jobs: dict) -> tuple[dict[str, str], list[str]]:
    """Starts every command of ``jobs`` (key -> argv) at once; returns each
    one's output and the failures."""
    procs = {key: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
             for key, cmd in jobs.items()}
    logs, failed = {}, []
    for key, proc in procs.items():
        logs[key], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(jobs[key])}\n{logs[key]}")
    return logs, failed


def build_all(names: Iterable[str], verbose: bool = False) -> dict[str, str]:
    """Compile every named kernel whose library is missing: one ``nvcc -c``
    per source, all started together, then one link per kernel.  Returns
    the compiler's log per source, keyed ``<kernel>/<file>`` ("" for the
    sources of a kernel that was already built); raises if any step fails."""
    logs: dict[str, str] = {}
    compiles, objects, links, tmps = {}, [], {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            logs.update({f"{name}/{src.name}": "" for src in sources(name)})
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        objs = []
        for src in sources(name):
            obj = out.with_name(f"{out.stem}.{src.stem}.{os.getpid()}.o")
            compiles[f"{name}/{src.name}"] = [
                _nvcc(), *NVCC_FLAGS, *(VERBOSE_FLAGS if verbose else ()), "-c",
                "-o", str(obj), str(src)]
            objs.append(obj)
        objects += objs
        tmps[name] = out.with_suffix(f".{os.getpid()}.tmp")
        links[name] = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmps[name]),
                       *map(str, objs)]
    try:
        compiled, failed = _run_all(compiles)
        logs.update(compiled)
        if not failed:
            _, failed = _run_all(links)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, tmp in tmps.items():
            os.replace(tmp, library_path(name))
    finally:
        for path in (*objects, *tmps.values()):
            path.unlink(missing_ok=True)
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
