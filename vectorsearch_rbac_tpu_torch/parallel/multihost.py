"""The process axis: ingestion and serving across processes over
torch.distributed.

Counterpart of vectorsearch_rbac_tpu/parallel/multihost.py. Each process
ingests only its slice of the corpus (`local_row_range`), quantizes it with
the GLOBAL quantization parameters (`scale_hint`: the dataset family's, or
from corpus statistics; fitting on the slice is exact only for integer
corpora), and keeps its rows sharded over its own mesh's devices
(`multihost_quant_arena`). The reference assembles one global jax.Array
from the processes' shards (`make_array_from_process_local_data`); torch
has none, so here the global view is the process group: serving runs
`sharded.sharded_int8_topk` in every process on the same queries, and its
merge all-gathers the (Q, S * k) candidates of every rank, rank-major,
before the exact merge. With one process (no group, or a group of one)
it is the in-process path, the reference's `process_count() == 1` branch.

The backend is named by the caller, never guessed (`start_process_group`):
gloo for CPU processes and for ranks that share one card (the candidates
then go through host memory); nccl where each rank owns its card (the
worker below puts rank r on cuda:r). A group that fails to start raises.

`spawn_flagship` runs the flagship over n processes on one machine: the
parent writes the corpus and queries once, each spawned rank reads its
slice, ingests and serves, and every rank's (dists, ids) come back; a rank
that fails, or a run past its deadline, raises.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import get_logger
from ..core import ArenaQuant, quantize_corpus, quantize_rows
from .mesh import SHARD_AXIS, make_mesh
from .sharded import ShardedArray, shard_rows, sharded_int8_topk

logger = get_logger("parallel.multihost")

BACKENDS = ("gloo", "nccl")


def process_index_count() -> Tuple[int, int]:
    """(rank, world size) in the default process group; (0, 1) with none
    started."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _pad(n: int, unit: int) -> int:
    return ((max(n, 1) + unit - 1) // unit) * unit


def local_row_range(n_global: int, block_rows: int = 4096,
                    process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> Tuple[int, int]:
    """[start, end) of the corpus rows this process ingests: the padded
    row space splits evenly over the processes on block boundaries."""
    pi, pc = process_index_count()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    per = _pad(n_global, block_rows * pc) // pc
    return pi * per, min((pi + 1) * per, n_global)


def start_process_group(backend: str, rank: int, world_size: int,
                        port: int, timeout_s: float = 30.0) -> None:
    """Join a process group of world_size ranks at tcp://localhost:port
    over the named backend ("gloo" or "nccl"). Raises where it cannot
    start: an unknown backend, or a rendezvous past timeout_s."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    torch.distributed.init_process_group(
        backend=backend, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def multihost_quant_arena(
    local_vectors: np.ndarray,      # this process's corpus slice (rows, d)
    local_doc_bits: np.ndarray,     # (rows, W) uint32 role bitsets
    mesh,                           # this process's mesh
    n_global: int,                  # corpus rows across all processes
    block_rows: int = 4096,
    scale_hint: Optional[Tuple[float, np.ndarray, int]] = None,
    # (scale, center, qclip): the quantization must be GLOBAL; without a
    # hint it is fitted on the slice (exact for integer-valued corpora)
) -> Tuple[ShardedArray, ShardedArray, ShardedArray,
           Tuple[float, np.ndarray, int]]:
    """Quantize this process's slice and row-shard it over its mesh. The
    slice pads to the same row count in every process (a whole number of
    blocks a shard), and the arrays carry the slice's first global row,
    so the ids a shard returns are corpus rows; with more than one process
    they are marked `across_processes`, so that their searches gather the
    candidates of every rank. Returns (codes, int32 norms, bitsets,
    (scale, center, qclip))."""
    rank, pc = process_index_count()
    start, _ = local_row_range(n_global, block_rows, rank, pc)
    per = _pad(n_global, block_rows * pc) // pc
    local_pad = _pad(per, block_rows * mesh.shape[SHARD_AXIS])
    n_local = local_vectors.shape[0]
    x = np.asarray(local_vectors, np.float32)
    if scale_hint is None:
        xq, nq_, scale, center, _, qclip = quantize_corpus(x, local_pad)
    else:
        scale, center, qclip = scale_hint
        xq, nq_ = quantize_rows(x, scale, center, qclip, local_pad)
    bits = np.zeros((local_pad, local_doc_bits.shape[1]), np.uint32)
    bits[:n_local] = local_doc_bits
    vq, nqd, bd = (shard_rows(mesh, a, row_offset=start,
                              across_processes=pc > 1)
                   for a in (xq, nq_, bits))
    logger.info("multihost arena: %d global rows, rows [%d, %d) on process "
                "%d of %d, %d padded over %d shards", n_global, start,
                start + n_local, rank, pc, local_pad, mesh.shape[SHARD_AXIS])
    return vq, nqd, bd, (float(scale), np.asarray(center, np.float32),
                         int(qclip))


# ---- the flagship over spawned processes

_FILES = ("vectors", "bits", "queries", "qbits", "center")


def flagship_worker(rank: int, world_size: int, port: int, backend: str,
                    device: str, local_shards: int, data_dir: str, k: int,
                    group: int, block_rows: int, timeout_s: float) -> None:
    """One rank of spawn_flagship: join the group, ingest this rank's
    slice of data_dir's corpus over a mesh of local_shards shards on
    `device` (nccl: cuda:rank), serve the flagship on every query and
    write this rank's (dists, ids) to data_dir/rank<r>.npz."""
    start_process_group(backend, rank, world_size, port, timeout_s)
    try:
        dev = f"cuda:{rank}" if backend == "nccl" else device
        arr = {name: np.load(os.path.join(data_dir, name + ".npy"),
                             mmap_mode="r") for name in _FILES}
        meta = np.load(os.path.join(data_dir, "meta.npy"))
        scale, qclip = float(meta[0]), int(meta[1])
        n = arr["vectors"].shape[0]
        s, e = local_row_range(n, block_rows)
        mesh = make_mesh(local_shards, devices=[dev] * local_shards)
        vq, nq, bits, _ = multihost_quant_arena(
            np.asarray(arr["vectors"][s:e]), np.asarray(arr["bits"][s:e]),
            mesh, n, block_rows,
            scale_hint=(scale, np.asarray(arr["center"]), qclip))
        quant = ArenaQuant(vectors_q=vq, norms_q=nq, scale=scale,
                           center=np.asarray(arr["center"]), lossless=False,
                           qclip=qclip)
        q8, qn = quant.quantize_queries(np.asarray(arr["queries"]))
        d, i = sharded_int8_topk(
            mesh, q8, qn, vq, nq, bits, np.array(arr["qbits"]),
            1.0 / scale**2, k, group=group, score_shift=quant.score_shift)
        np.savez(os.path.join(data_dir, f"rank{rank}.npz"),
                 d=d.cpu().numpy(), i=i.cpu().numpy())
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_flagship(n_procs: int, local_shards: int, device: str,
                   backend: str, vectors: np.ndarray, bits: np.ndarray,
                   queries: np.ndarray, qbits: np.ndarray,
                   scale_hint: Tuple[float, np.ndarray, int], k: int,
                   group: int, block_rows: int, timeout_s: float = 30.0,
                   deadline_s: float = 55.0
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The flagship over n_procs spawned ranks of one process group, each
    ingesting its slice of `vectors` onto local_shards shards: every
    rank's (dists (Q, k), ids (Q, k)). The group's rendezvous waits at
    most timeout_s, the whole run deadline_s; a rank that exits non-zero
    or a run past its deadline raises (the ranks still alive are
    terminated first)."""
    import multiprocessing

    scale, center, qclip = scale_hint
    with tempfile.TemporaryDirectory(prefix="vsr_multihost_") as data_dir:
        for name, a in zip(_FILES, (vectors, bits, queries, qbits, center)):
            np.save(os.path.join(data_dir, name + ".npy"),
                    np.ascontiguousarray(a))
        np.save(os.path.join(data_dir, "meta.npy"),
                np.asarray([scale, qclip], np.float64))
        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        procs = [ctx.Process(target=flagship_worker, args=(
            r, n_procs, port, backend, device, local_shards, data_dir, k,
            group, block_rows, timeout_s)) for r in range(n_procs)]
        for p in procs:
            p.start()
        end = time.monotonic() + deadline_s
        try:
            for p in procs:
                p.join(max(end - time.monotonic(), 0.0))
        finally:
            late = [p for p in procs if p.is_alive()]
            for p in late:
                p.terminate()
            for p in late:
                p.join(5.0)
        if late:
            raise TimeoutError(f"{len(late)} of {n_procs} ranks still ran "
                               f"after {deadline_s} s")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"ranks exited non-zero: {bad}")
        out = []
        for r in range(n_procs):
            with np.load(os.path.join(data_dir, f"rank{r}.npz")) as z:
                out.append((z["d"], z["i"]))
        return out
