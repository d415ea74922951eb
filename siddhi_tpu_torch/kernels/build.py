"""Build the CUDA sources under `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `_build/lib<name>-<hash>.so` (a plain C
interface, no PyTorch headers, so a build takes seconds), compiled at first
use for Hopper (`sm_90a`) with `--fmad=false`: the plain versions and the
JAX reference never contract `a*b+c` into an FMA, so neither do the kernels.
The hash covers every source and the flags, so a stale library is never
loaded.  `build_all()` starts one nvcc per source at once and waits.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
SOURCES = ("expr_eval", "nfa_block", "nfa_block_wide", "nfa_block_ext",
           "nfa_block_wide_ext", "nfa_block_chunk", "nfa_block_chunk_ext",
           "nfa_block_f64", "nfa_block_wide_f64", "nfa_block_ext_f64",
           "nfa_block_wide_ext_f64", "nfa_block_chunk_f64",
           "nfa_block_chunk_ext_f64", "seg_tree",
           "scan_chase", "scan_compact", "win_scan", "win_range",
           "win_compact", "join_probe", "agg_merge", "dfa_tables")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_libs: dict = {}
_lock = threading.Lock()
BUILD_LOG: dict = {}        # name -> nvcc's stderr (ptxas register report)


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of siddhi_tpu_torch "
                       "build with the CUDA toolkit (set NVCC)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    return h.hexdigest()[:12]


def _lib_path(name: str, digest: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every missing library in parallel; returns name -> path."""
    digest = _digest()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name, digest)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: _lib_path(name, digest) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build_all((name,))[name])
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA error {err} from {what}")
