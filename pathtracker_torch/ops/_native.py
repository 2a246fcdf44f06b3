"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone (no PyTorch headers, which cost minutes a build) into
``build/lib<name>_<hash>.so``; the hash covers the source and the flags, so
an edited source builds anew. The library is loaded with ``ctypes``.
Nothing here runs at import: the first launch builds and loads, and
``build()`` does it ahead of time, one ``nvcc`` per source, all at once.

Every exported function takes its tensors' device pointers, the row count
and the CUDA stream, launches on that stream without synchronising or
allocating, and returns ``cudaGetLastError()`` after the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# source name -> {exported function: number of tensor pointers it takes}
SIGNATURES = {
    "int_cell": {"k1_attention_fwd": 6, "k2_inhibition_fwd": 13,
                 "k3_excitation_fwd": 16},
}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from csrc/ at first use")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}_{digest}.so"


def build(names=None) -> list[str]:
    """Compile every named source (default: all) that has no library yet;
    returns the names compiled. Raises with nvcc's output if one fails."""
    todo = [n for n in (names or SIGNATURES) if not library_path(n).exists()]
    if not todo:
        return []
    nvcc = _nvcc()
    BUILD.mkdir(exist_ok=True)
    procs = []
    for name in todo:
        tmp = f"{library_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return todo


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, n_ptrs in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_longlong,
                                                       ctypes.c_void_p]
            f.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def launch(name: str, fn: str, tensors, rows: int, stream: int) -> None:
    """Call ``fn`` of ``csrc/<name>.cu``; raise if the launch failed."""
    lib = _library(name)
    if len(tensors) != SIGNATURES[name][fn]:
        raise ValueError(f"{fn} takes {SIGNATURES[name][fn]} tensors, "
                         f"got {len(tensors)}")
    err = getattr(lib, fn)(*[t.data_ptr() for t in tensors], rows, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")
