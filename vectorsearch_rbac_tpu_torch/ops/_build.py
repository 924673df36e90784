"""Build the CUDA kernels with nvcc and bind them with ctypes.

Every `*.cu` file under the package's `csrc/` compiles into ONE shared
library with a plain C interface, for `sm_90a` (Hopper). The library's
name carries a hash of the sources, so an edited kernel never loads a
stale build and an unchanged one builds once per checkout. The build runs
at first use, never at import: the CPU-only test environment imports every
module and has no nvcc.

Each C entry point takes raw device pointers, ints and the CUDA stream,
launches on that stream without synchronising, and returns
`cudaGetLastError()`; `check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# <checkout>/build/kernels: listed in .gitignore
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launch counts, one per kernel: a wrapper adds one where it launches its
# kernel and nowhere else, so a run can show that it went through them.
LAUNCHES = {"scan_int8": 0, "merge_extract": 0, "merge_bitonic": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q8, x8, norms, row_bits, q_bits, out, nq, npad, d_pad, w, group, l2,
    # score_shift, stream
    "vsr_scan_int8": [_P] * 6 + [_I] * 7 + [_P],
    # mins, out_y, out_m, nq, nsub, sub, t, stream
    "vsr_extract_pairs": [_P] * 3 + [_I] * 4 + [_P],
    # y, meta, out_y, out_m, nq, npc, keep, stream
    "vsr_bitonic_pairs": [_P] * 4 + [_I] * 3 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA "
            "kernels are built on a machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvsrbac_kernels_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile csrc/*.cu into the hashed library unless it exists.
    Returns (library path, nvcc's output: ptxas's register and spill
    report; empty when the library was already built)."""
    so = library_path()
    if so.is_file():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources()]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, so)   # atomic: a concurrent loader never sees half a file
    return so, log


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        so, _ = build()
        handle = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.vsr_error_string.argtypes = [ctypes.c_int]
        handle.vsr_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib().vsr_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
