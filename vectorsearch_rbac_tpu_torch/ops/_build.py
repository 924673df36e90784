"""Build the CUDA kernels with nvcc and bind them with ctypes.

Every `*.cu` file under the package's `csrc/` compiles, one nvcc process
per source and all of them at once, into an object for `sm_90a` (Hopper);
the objects link into ONE shared library with a plain C interface. The
library's name carries a hash of the sources and of the headers they
include (`csrc/*.cuh`), so an edited kernel or header never loads a stale
build and an unchanged one builds once per checkout. The build runs
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

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

# Launch counts, one per kernel: a wrapper adds one where it launches its
# kernel and nowhere else, so a run can show that it went through them.
# "scan_int8" counts every launch of the narrow scan, "scan_int8_slots" the
# launches of its admit-dedup slot form among them, and "scan_int8_wide" /
# "scan_int8_wide_slots" the same for the wide scan; "graph_search" counts
# the fused graph search (one launch a search), "graph_score" and
# "graph_merge" the step kernels of the step loop, and "graph_search_ip" and
# "graph_score_ip" the launches of the inner-product score form (ip and
# cosine arenas) among those of "graph_search" and "graph_score". The kernel lab's
# variants count on their own: the dp4a scan, the tensor-core scan's trim
# (K1's per-query form), floor and chain forms, the y-form extraction and
# the y-form bitonic sort in its two forms.
LAUNCHES = {"scan_int8": 0, "scan_int8_slots": 0, "scan_int8_wide": 0,
            "scan_int8_wide_slots": 0, "merge_extract": 0,
            "merge_bitonic": 0, "graph_search": 0, "graph_score": 0,
            "graph_merge": 0, "graph_search_ip": 0, "graph_score_ip": 0,
            "scan_int8_dp4a": 0, "scan_int8_trim": 0, "scan_int8_floor": 0,
            "scan_int8_chain": 0,
            "merge_y_extract": 0, "merge_y_sort": 0, "merge_y_pairs": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # ids, row_map, pids, n_class, packed, unit_bytes, qf, qmask, qcd,
    # dq_scale, out_s, out_ok, nq, c, d_pad, w, ip, stream
    "vsr_graph_score_packed": [_P] * 3 + [_I, _P, _I] + [_P] * 3 + [_F]
    + [_P] * 2 + [_I] * 5 + [_P],
    # beam_d, beam_i, nd, nb, w_d, res_d, res_i, cand_d, cand_i, the five
    # outputs, nq, ef, c, kk, cr, stream
    "vsr_graph_merge_step": [_P] * 14 + [_I] * 5 + [_P],
    # qf, qmask, qcd, dq_scale, packed, unit_bytes, graph, m0, row_map,
    # pids, n_class, entries, step_budget, out_d, out_i, stats, nq, d_pad,
    # w, ef, kk, max_steps, ip, stream
    "vsr_graph_search_fused": [_P] * 3 + [_F, _P, _I, _P, _I] + [_P] * 2
    + [_I] + [_P] * 5 + [_I] * 7 + [_P],
    # q8, x8, norms, row_bits, q_bits, out, nq, npad, d_pad, w, group, l2,
    # score_shift, mask_sb, slot_tile, stream
    "vsr_scan_int8": [_P] * 6 + [_I] * 9 + [_P],
    # the same arguments
    "vsr_scan_int8_wide": [_P] * 6 + [_I] * 9 + [_P],
    # q8, x8, norms, row_bits, q_bits, out, nq, npad, d_pad, w, group, l2,
    # score_shift, variant, stream
    "vsr_scan_int8_lab": [_P] * 6 + [_I] * 8 + [_P],
    # mins, out_y, out_m, nq, nsub, sub, t, stream
    "vsr_extract_pairs": [_P] * 3 + [_I] * 4 + [_P],
    # y, meta, out_y, out_m, nq, npc, keep, stream
    "vsr_bitonic_pairs": [_P] * 4 + [_I] * 3 + [_P],
    # mins, out, nq, nsub, sub, t, stream
    "vsr_y_extract": [_P] * 2 + [_I] * 4 + [_P],
    # y, out_y, out_g, nq, npc, keep, t, sub, pairs, stream
    "vsr_bitonic_y": [_P] * 3 + [_I] * 6 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


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
    for src in (*_sources(), *_headers()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvsrbac_kernels_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile csrc/*.cu into the hashed library unless it exists: one nvcc
    per source, all started together, then one link. Returns (library
    path, nvcc's output: ptxas's register and spill report per source;
    empty when the library was already built)."""
    so = library_path()
    if so.is_file():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    logs, failed = [], []
    for src, proc in zip(_sources(), procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    try:
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n"
                               + "".join(logs))
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               + "".join(logs))
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, so)   # atomic: a concurrent loader never sees half a file
    return so, "".join(logs)


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
