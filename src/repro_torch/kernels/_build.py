"""Build and bind the port's CUDA kernels (``src/repro_torch/csrc``).

Each ``.cu`` source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface under ``build/repro_torch/<digest>/`` at the root
of the checkout, and loaded with ``ctypes``.  The digest covers the
sources, the flags and the compiler, so an edited kernel rebuilds and an
unchanged one is reused.  The build runs at first use, under a file lock,
and a failed build raises: no caller ever proceeds without the kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: build/ at the root of the checkout (src/repro_torch/kernels -> root)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("spmm_ell.cu", "tile_fused_gemm_spmm.cu",
           "tile_fused_spmm_spmm.cu", "flash_attention.cu", "fused_ffn.cu")
HEADERS = ("common.cuh", "hopper.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIBRARY = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
#: argtypes of every launcher (each returns the cudaError_t of its launch)
#: and of the four dispatch records (``*_last_path``)
SIGNATURES = {
    "spmm_ell_launch": (_P,) * 12 + (_I64,) + (_I,) * 6 + (_P,),
    "spmm_ell_last_path": (),
    "tile_fused_gemm_spmm_wf0_launch": (_P,) * 7 + (_I,) * 9 + (_P,),
    "tile_fused_gemm_spmm_wf0_last_path": (),
    "tile_fused_spmm_spmm_wf0_launch": (_P,) * 8 + (_I,) * 8 + (_P,),
    "flash_attention_launch": (_P,) * 4 + (_I,) * 6 + (_F,) + (_I,) * 3
    + (_P,),
    "flash_attention_last_path": (),
    "fused_ffn_launch": (_P,) * 4 + (_I,) * 5 + (_P,),
    "fused_moe_ffn_launch": (_P,) * 4 + (_I,) * 6 + (_P,),
    "fused_ffn_last_path": (),
}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path          # the shared library
    log: str            # nvcc / ptxas output (-Xptxas -v: registers, smem)
    seconds: float      # wall time of this call (0-ish when reused)
    reused: bool        # True when an identical earlier build was loaded


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "cannot be built")
    return found


def _digest(compiler: str) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(compiler.encode())
    return h.hexdigest()[:16]


def _run_all(cmds: list) -> str:
    """Run the commands concurrently; return their joined output, raise
    with it if any failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "\n".join(f"$ {' '.join(cmd)}\n{out}" for cmd, out in
                    zip(cmds, outs))
    if any(p.returncode for p in procs):
        raise RuntimeError(f"CUDA kernel build failed:\n{log}")
    return log


def build() -> Build:
    """Compile and link the kernels unless an identical build exists."""
    t0 = time.perf_counter()
    compiler = nvcc()
    out_dir = BUILD_ROOT / _digest(compiler)
    lib = out_dir / LIBRARY
    log_path = out_dir / "build.log"
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return Build(lib, log_path.read_text(),
                         time.perf_counter() - t0, True)
        out_dir.mkdir(parents=True, exist_ok=True)
        objs = [out_dir / (Path(src).stem + ".o") for src in SOURCES]
        log = _run_all([[compiler, *FLAGS, "-c", str(CSRC / src), "-o",
                         str(obj)] for src, obj in zip(SOURCES, objs)])
        tmp = out_dir / (LIBRARY + ".tmp")
        log += _run_all([[compiler, "-shared", "-o", str(tmp),
                          *map(str, objs)]])
        log_path.write_text(log)
        tmp.rename(lib)   # atomic: a library that exists is complete
    return Build(lib, log, time.perf_counter() - t0, False)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
