"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone (no PyTorch headers, which cost minutes a build) into
``build/lib<name>_<hash>.so``; the hash covers the source, the ``csrc/``
headers it includes (``ring.cuh``: the ring kernels' shared pieces) and the
flags, so an edited source or header builds anew. ``ptxas -v``'s account of
each kernel (registers, shared memory, spills) is kept beside it as
``.log``. The
library is loaded with ``ctypes``. Nothing here runs at import: the first
launch builds and loads, and ``build()`` does it ahead of time, one ``nvcc``
per source, all at once.

Every exported kernel function takes its tensors' device pointers, then its
integer arguments (each a ``long long``: the row count of the InT cell
kernels; N, H, W, C, patch and dilation of the correlation kernels) and the
CUDA stream, launches on that stream without synchronising or allocating,
and returns ``cudaGetLastError()`` after the launch (or the error that made
it refuse the arguments). An InT backward kernel also exports
``<function>_blocks(rows)``: the grid it launches, which sizes the per-block
partial-sum workspace its wrapper allocates; the C function finishes the sum
over that workspace itself (a second small kernel on the same stream) and
returns the final gradients.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source name -> {exported function: (tensor pointers, integer arguments)}
SIGNATURES = {
    "int_cell": {"k1_attention_fwd": (6, 1), "k2_inhibition_fwd": (13, 1),
                 "k3_excitation_fwd": (16, 1)},
    "int_cell_bwd": {"k1_attention_bwd": (11, 1), "k2_inhibition_bwd": (20, 1),
                     "k3_excitation_bwd": (25, 1)},
    "correlation": {"correlation_fwd": (3, 6), "correlation_bwd_f1": (3, 6),
                    "correlation_bwd_f2": (3, 6)},
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


def included_headers(name: str) -> list[str]:
    """The ``csrc/`` headers ``csrc/<name>.cu`` includes (``#include "x.cuh"``)."""
    source = (CSRC / f"{name}.cu").read_text()
    return sorted(set(re.findall(r'^#include "(\w+\.cuh)"', source, flags=re.M)))


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in included_headers(name):
        digest.update(header.encode() + b"\0" + (CSRC / header).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output for the built ``csrc/<name>.cu`` (ptxas -v: registers,
    shared memory and spill bytes per kernel)."""
    return library_path(name).with_suffix(".log").read_text()


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
            library_path(name).with_suffix(".log").write_text(out)
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return todo


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (n_ptrs, n_ints) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = ([ctypes.c_void_p] * n_ptrs
                          + [ctypes.c_longlong] * n_ints + [ctypes.c_void_p])
            f.restype = ctypes.c_int
            if hasattr(lib, fn + "_blocks"):
                q = getattr(lib, fn + "_blocks")
                q.argtypes, q.restype = [ctypes.c_longlong], ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def blocks(name: str, fn: str, rows: int) -> int:
    """The grid ``fn`` launches for ``rows`` rows: the leading size of its
    per-block partial workspace."""
    n = getattr(_library(name), fn + "_blocks")(rows)
    if n <= 0:
        raise RuntimeError(f"{fn}_blocks({rows}) returned {n}")
    return n


def launch(name: str, fn: str, tensors, ints, stream: int) -> None:
    """Call ``fn`` of ``csrc/<name>.cu`` with its tensors, its integer
    arguments (one int or a sequence of them) and the stream; raise if the
    launch failed. A ``None`` among ``tensors`` is passed as a null pointer."""
    lib = _library(name)
    ints = (ints,) if isinstance(ints, int) else tuple(ints)
    n_ptrs, n_ints = SIGNATURES[name][fn]
    if len(tensors) != n_ptrs or len(ints) != n_ints:
        raise ValueError(f"{fn} takes {n_ptrs} tensors and {n_ints} integers, "
                         f"got {len(tensors)} and {len(ints)}")
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    err = getattr(lib, fn)(*ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")
