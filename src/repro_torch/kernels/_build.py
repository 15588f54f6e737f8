"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds).  The library is named by a hash of the sources and flags and
lives in ``build/kernels/`` at the root of the checkout, so the first call
after a change to a source builds it and later calls load it.  A failed build
raises: there is no other route to a kernel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

import torch

__all__ = ["BUILD_DIR", "build", "library", "check", "dtype_code", "stream_ptr"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's kernels are built on the machine with the card")


def build() -> Path:
    """Compile the kernels if this set of sources has not been built yet.

    Returns the library's path.  The compiler's report (``-Xptxas -v``:
    registers, shared memory and spills per kernel) is kept beside it as
    ``<library>.log``.
    """
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib = BUILD_DIR / f"libkernels-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{p.stem}.o") for p in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
            for p, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    if all(p.returncode == 0 for p in procs):
        proc = subprocess.run(link, capture_output=True, text=True)
        cmds.append(link)
        outs.append(proc.stdout + proc.stderr)
        failed = proc.returncode
    else:
        failed = next(p.returncode for p in procs if p.returncode)
    lib.with_suffix(".so.log").write_text("".join(
        " ".join(c) + "\n" + out for c, out in zip(cmds, outs)))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n" + "".join(outs))
    os.replace(tmp, lib)        # atomic: a concurrent loader sees all or none
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, with typed entry points."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rms_norm_fwd.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, i32,
                                 ctypes.c_float, i32, ptr]
    lib.rms_norm_fwd.restype = i32
    lib.flash_attention_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                        i32, i32, ctypes.c_float, i32, ptr]
    lib.flash_attention_fwd.restype = i32
    # x, dt, A, Bc, Cc, y, then the workspaces cum, dt, cb, states
    lib.ssd_scan_fwd.argtypes = [ptr] * 10 + [i32] * 7 + [ptr]
    lib.ssd_scan_fwd.restype = i32
    i64 = ctypes.c_longlong
    lib.dma_copy_pipelined.argtypes = [ptr, ptr, i64, i64, i32, i32, i64, ptr]
    lib.dma_copy_explicit.argtypes = [ptr, ptr, i64, i64, i32, i32, ptr]
    lib.dma_copy_occupancy.argtypes = [i32, i64, i64, i32, i32, i64,
                                       ctypes.POINTER(i64), ctypes.POINTER(i32)]
    for fn in (lib.dma_copy_pipelined, lib.dma_copy_explicit,
               lib.dma_copy_occupancy):
        fn.restype = i32
    lib.inline_put_prepare.argtypes = []
    lib.inline_put_prepare.restype = i32
    lib.inline_put_launch.argtypes = [ptr, i64, ptr, ptr]
    lib.inline_put_launch.restype = i32
    lib.exec_graph_prepare.argtypes = []
    lib.exec_graph_node.argtypes = [ptr, ptr, ptr, i32, ptr]
    lib.exec_graph_multistep_build.argtypes = [ptr, ptr, ptr, i32, i32, ptr,
                                               ctypes.POINTER(ptr)]
    lib.exec_graph_multistep_launch.argtypes = [ptr, ptr]
    lib.exec_graph_multistep_graphs.argtypes = [ptr, ctypes.POINTER(ptr),
                                                ctypes.POINTER(ptr)]
    lib.exec_graph_multistep_graphs.restype = None
    lib.exec_graph_multistep_destroy.argtypes = [ptr]
    lib.graph_footprint.argtypes = [ptr, ctypes.c_char_p, ctypes.POINTER(i64),
                                    ctypes.POINTER(i64)]
    lib.graph_upload.argtypes = [ptr, ptr]
    for fn in (lib.exec_graph_prepare, lib.exec_graph_node,
               lib.exec_graph_multistep_build, lib.exec_graph_multistep_launch,
               lib.exec_graph_multistep_destroy, lib.graph_footprint,
               lib.graph_upload):
        fn.restype = i32
    lib.kernels_error_string.argtypes = [i32]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs)."""
    if err != 0:
        msg = library().kernels_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err}: {msg}")


def dtype_code(dtype: torch.dtype) -> int:
    return _DTYPE_CODES[dtype]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
