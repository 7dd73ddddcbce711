"""Build the CUDA sources with ``nvcc`` and bind them through ``ctypes``.

Each ``kernels/<name>/csrc/<name>.cu`` has a plain C interface and compiles
on its own into ``build/kernels/lib<name>-<digest>.so`` at the repository
root (a directory ``.gitignore`` lists). The digest covers the source and the
flags, so an edited source builds anew and a stale library is never loaded.
``build()`` starts one ``nvcc`` per missing library, all at once, and waits
for every one; ``function()`` builds on first use and returns the bound C
entry with explicit ``argtypes``.

Every C entry returns ``cudaGetLastError()`` after its launches (0 on
success); ``check()`` turns a nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
KERNELS = ("pointer_jump", "list_rank", "hook_edges", "frontier_relax",
           "segment_table")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def source(name: str) -> pathlib.Path:
    return _PKG / name / "csrc" / f"{name}.cu"


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256(source(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
        if not candidate.exists():
            raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; "
                               "the CUDA kernels cannot be built")
        nvcc = str(candidate)
    return nvcc


def build(names=KERNELS) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet.

    One ``nvcc`` process per source, all started together. Each writes to a
    temporary name and is renamed into place, so concurrent builders never
    load a half-written library. Returns ``{name: ptxas report}`` for the
    libraries compiled by this call; raises if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: list):
    """The C entry ``symbol`` of library ``name``, built and bound."""
    fn = getattr(_library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, rc: int) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        msg = _library(name).kernel_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel: CUDA error {rc} ({msg})")
