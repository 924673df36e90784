"""ctypes bindings for the native HNSW builder (native/hnsw_builder.cpp).

Counterpart of vectorsearch_rbac_tpu/native/__init__.py for the four entry
points the port's HNSW index calls: `hnsw_build` (the classic builder),
`hnsw_build_acorn` (the ACORN-gamma builder: dense layer-0 lists),
`rng_prune` (the alpha-RNG prune of the kNN builder) and `insert_update`
(the online edge update of HNSWIndex.insert_rows and refine_rows). The
library is built at first use with g++ and the reference's Makefile
flags (and -pthread: the prune's per-node pass runs in threads) into
`<checkout>/build/native/` (git-ignored), under a name that carries a hash
of the source, the flags and the host CPU, so an edited source, or a
checkout copied to another machine, never loads a stale build. A failed
build raises: there is no silent pure-Python fallback.

The ctypes calls release the GIL, so independent builds (one per
partition, each seeded) may run in a thread pool; each call allocates its
own state and the outputs do not depend on the threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "hnsw_builder.cpp"
# <checkout>/build/native: listed in .gitignore
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
            "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _cpu_fingerprint() -> bytes:
    """The host CPU's model and feature flags: -march=native code built on
    one machine may not run on another that shares the checkout."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return os.uname().machine.encode()
    keep = [ln for ln in text.splitlines()
            if ln.startswith(("model name", "flags", "Features"))]
    return "\n".join(sorted(set(keep))).encode()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()
                       + _cpu_fingerprint())
    return BUILD_DIR / f"libvsrbac_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the builder unless the hashed library exists; raises with
    the compiler's output if g++ fails or is missing."""
    so = library_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    try:
        out = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp),
                              str(SOURCE)], capture_output=True, text=True,
                             timeout=300)
    except OSError as e:
        raise RuntimeError(f"native HNSW builder: cannot run {cxx}: {e}")
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native HNSW builder: {cxx} failed "
                           f"({out.returncode}):\n{out.stdout}{out.stderr}")
    os.replace(tmp, so)   # atomic: a concurrent loader never sees half a file
    return so


def lib() -> ctypes.CDLL:
    """The builder library, built on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            f32p = ctypes.POINTER(ctypes.c_float)
            handle.vsr_hnsw_build.restype = ctypes.c_int
            handle.vsr_hnsw_build.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_uint64, i32p, i32p, i32p]
            handle.vsr_hnsw_build_acorn.restype = ctypes.c_int
            handle.vsr_hnsw_build_acorn.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_uint64, i32p, i32p,
                i32p]
            handle.vsr_rng_prune.restype = ctypes.c_int
            handle.vsr_rng_prune.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int, i32p, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, i32p]
            handle.vsr_insert_update.restype = ctypes.c_int
            handle.vsr_insert_update.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int, i32p, i32p,
                ctypes.c_int64, ctypes.c_int, i32p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                i32p, i32p, i32p]
            _lib = handle
    return _lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def hnsw_build(vectors: np.ndarray, m: int = 16, ef_construction: int = 64,
               seed: int = 0) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Build an HNSW graph. Returns (neighbors0 (n, 2m) int32, levels (n,),
    entry_point, max_level)."""
    vec = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = vec.shape
    nbr = np.full((n, 2 * m), -1, dtype=np.int32)
    levels = np.zeros(n, dtype=np.int32)
    entry = np.zeros(1, dtype=np.int32)
    max_level = lib().vsr_hnsw_build(_f32p(vec), n, d, m, ef_construction,
                                     seed, _i32p(nbr), _i32p(levels),
                                     _i32p(entry))
    if max_level < 0:
        raise RuntimeError("vsr_hnsw_build failed")
    return nbr, levels, int(entry[0]), int(max_level)


def hnsw_build_acorn(vectors: np.ndarray, m: int = 16, m_beta: int = 64,
                     ef_construction: int = 64, seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """ACORN-gamma densified HNSW build (the reference's gamma 12, M_beta
    64): layer-0 lists hold a heuristic-selected navigable core of m edges
    plus the nearest pruned candidates up to m_beta (at least 2m), so a
    predicate-filtered traversal keeps admissible edges at low selectivity.
    Returns (neighbors0 (n, m_beta) int32, levels (n,), entry_point,
    max_level)."""
    vec = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = vec.shape
    m_beta = max(m_beta, 2 * m)
    nbr = np.full((n, m_beta), -1, dtype=np.int32)
    levels = np.zeros(n, dtype=np.int32)
    entry = np.zeros(1, dtype=np.int32)
    max_level = lib().vsr_hnsw_build_acorn(
        _f32p(vec), n, d, m, m_beta, ef_construction, seed, _i32p(nbr),
        _i32p(levels), _i32p(entry))
    if max_level < 0:
        raise RuntimeError("vsr_hnsw_build_acorn failed")
    return nbr, levels, int(entry[0]), int(max_level)


def rng_prune(vectors: np.ndarray, knn: np.ndarray, m: int = 16,
              alpha: float = 1.2) -> np.ndarray:
    """Prune a kNN candidate graph into a navigable (n, 2m) adjacency."""
    vec = np.ascontiguousarray(vectors, dtype=np.float32)
    knn = np.ascontiguousarray(knn, dtype=np.int32)
    n, d = vec.shape
    out = np.full((n, 2 * m), -1, dtype=np.int32)
    rc = lib().vsr_rng_prune(_f32p(vec), n, d, _i32p(knn), knn.shape[1], m,
                             ctypes.c_float(alpha), _i32p(out))
    if rc != 0:
        raise RuntimeError("vsr_rng_prune failed")
    return out


def insert_update(vec_table: np.ndarray, vmap: np.ndarray, graph: np.ndarray,
                  cand: np.ndarray, n_old: int, m: int, alpha: float = 1.2,
                  nodes: Optional[np.ndarray] = None) -> np.ndarray:
    """The online edge update (the reference's insert_update): each node's
    candidates (local ids, -1 pads) alpha-RNG pruned to m edges in L2 over
    `vec_table[vmap[local]]`, then reverse edges into free slots, or over
    the farthest edge where the node is nearer. `graph` ((npad, M0) int32,
    C-contiguous) is updated in place. Insert mode (nodes None): the nodes
    are n_old .. n_old + len(cand) - 1, and same-batch nodes that listed a
    common candidate become each other's candidates. Refine mode (`nodes`:
    existing local ids): candidates add the node's current list, reverse
    edges skip targets that already link back, no peers. Returns the
    changed rows: in insert mode the old rows only (the new ones always
    change), in refine mode every row touched."""
    vec = np.ascontiguousarray(vec_table, dtype=np.float32)
    vm = np.ascontiguousarray(vmap, dtype=np.int32)
    if graph.dtype != np.int32 or not graph.flags.c_contiguous:
        raise ValueError("insert_update updates a C-contiguous int32 graph "
                         "in place")
    cd = np.ascontiguousarray(cand, dtype=np.int32)
    n_new = cd.shape[0]
    changed = np.empty(n_new * m + n_new, dtype=np.int32)
    n_changed = ctypes.c_int32(len(changed))
    nd = None
    if nodes is not None:
        nd = np.ascontiguousarray(nodes, dtype=np.int32)
        if len(nd) != n_new:
            raise ValueError(f"{len(nd)} nodes for {n_new} candidate rows")
    rc = lib().vsr_insert_update(
        _f32p(vec), vec.shape[0], vec.shape[1], _i32p(vm), _i32p(graph),
        graph.shape[0], graph.shape[1], _i32p(cd), n_new, cd.shape[1],
        n_old, m, ctypes.c_float(alpha), _i32p(changed),
        ctypes.byref(n_changed),
        _i32p(nd) if nd is not None
        else ctypes.cast(None, ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError(f"vsr_insert_update failed ({rc})")
    return changed[:n_changed.value]
