"""Cold start on the card: restore the serving state from snapshots in a
fresh process, against building it.

    python -m vectorsearch_rbac_tpu_torch.bench.cold_start [--dir DIR]

The port's runner for scripts/cold_start_bench.py. Two OS processes, so
that nothing warm leaks into the load:

- build: the SIFT-like corpus (sift_like_corpus(1,000,000 rows, 100
  blocks a document, seed 0)), the bench's tree world (100 roles, 10,000
  users), the int8 arena (block_rows 131072), the global rls
  Int8FlatIndex (ids wire, group 128) and its first 2,048-query batch,
  the ROLE TiledSearcher and its first batch; then the arena snapshot,
  the tiled engine's light and packed snapshots and the world's pickle
  are saved.
- load: the arena and the world restored, the rls index over the restored
  arena and its first batch, the TiledSearcher restored from the light
  snapshot and its first batch; then, timed apart, from the packed one.

The queries are the reference script's: 2,048 integer vectors in [0, 256)
and uniform users from default_rng(5). Each phase prints the sha256 of
its engines' ids; the parent process fails unless the restored engines'
ids equal the built ones', bit for bit. The CUDA kernels are built once,
by the parent process, before either phase (`kernel_build_s`), so neither
phase pays nvcc. Prints one JSON line with the fields of
results/cold_start.json, the digests, and the card's nvidia-smi name and
power limit. Exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

N, NQ, K = 1_000_000, 2048, 100
_ROOT = Path(__file__).resolve().parents[2]   # the checkout


def _queries(dim: int, world):
    rng = np.random.default_rng(5)
    q = rng.integers(0, 256, (NQ, dim)).astype(np.float32)
    users = rng.integers(0, world.num_users, NQ)
    return q, users


def _digest(ids: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(ids, dtype=np.int64).tobytes()).hexdigest()


def _rls_index(arena, world):
    from ..index.flat_int8 import Int8FlatIndex

    idx = Int8FlatIndex(arena, None, query_batch=2048, q_tile=2048,
                        block_rows=8192, group=128, wire="ids")
    idx.set_user_table(world.user_masks)
    return idx


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _first_batch(fn, device):
    """(fn(), its seconds to the device's last kernel)."""
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def phase_build(snap: str, device) -> Dict:
    from ..config import FrameworkConfig
    from ..core import build_device_arena
    from ..data import sift_like_corpus
    from ..partition.strategies import build_role_searcher
    from ..rbac import TreeRBACGenerator
    from ..utils.persist import save_arena_snapshot, save_pickle

    rep: Dict = {}
    t0 = time.perf_counter()
    corpus, _ = sift_like_corpus(num_vectors=N, seed=0)
    rep["corpus_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    world = TreeRBACGenerator(num_users=10_000, num_roles=100,
                              num_docs=corpus.num_docs, h=4, b0=3, b1=4,
                              seed=0).generate()
    rep["world_gen_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=131072, dtype="int8")
    _sync(device)
    rep["arena_build_s"] = time.perf_counter() - t0
    q, users = _queries(corpus.dim, world)
    masks = world.user_masks[users]

    t0 = time.perf_counter()
    (_, rls_ids), _ = _first_batch(
        lambda: _rls_index(arena, world).search(q, masks, K), device)
    rep["rls_build_plus_first_query_s"] = time.perf_counter() - t0
    cfg = FrameworkConfig(seed=0)
    cfg.index.kind = "flat_approx"
    t0 = time.perf_counter()
    tiled = build_role_searcher(corpus, world, arena, cfg)
    _sync(device)
    rep["tiled_build_s"] = time.perf_counter() - t0
    (_, tiled_ids), rep["tiled_first_query_s"] = _first_batch(
        lambda: tiled.search_batch(q, users, world.user_masks, K), device)

    t0 = time.perf_counter()
    save_arena_snapshot(arena, f"{snap}/arena.npz")
    tiled.save_snapshot(f"{snap}/tiled_role.npz")
    save_pickle(world, f"{snap}/world.pkl")
    rep["snapshot_save_s"] = time.perf_counter() - t0
    rep["snapshot_bytes"] = sum(os.path.getsize(f"{snap}/{f}") for f in
                                ("arena.npz", "tiled_role.npz"))
    t0 = time.perf_counter()
    tiled.save_snapshot(f"{snap}/tiled_role_packed.npz", pack_arrays=True)
    rep["packed_snapshot_save_s"] = time.perf_counter() - t0
    rep["packed_snapshot_bytes"] = os.path.getsize(
        f"{snap}/tiled_role_packed.npz")
    rep["rls_ids_sha256"] = _digest(rls_ids)
    rep["tiled_ids_sha256"] = _digest(tiled_ids)
    return rep


def phase_load(snap: str, device) -> Dict:
    from ..partition.strategies import role_router
    from ..partition.tiled import TiledSearcher
    from ..utils.persist import load_arena_snapshot, load_pickle

    rep: Dict = {}
    t_all = time.perf_counter()
    world = load_pickle(f"{snap}/world.pkl")
    arena = load_arena_snapshot(f"{snap}/arena.npz", device)
    _sync(device)
    rep["arena_load_s"] = time.perf_counter() - t_all
    q, users = _queries(arena.dim, world)
    masks = world.user_masks[users]
    (_, rls_ids), rep["rls_first_query_s"] = _first_batch(
        lambda: _rls_index(arena, world).search(q, masks, K), device)
    rep["rls_load_to_first_query_s"] = time.perf_counter() - t_all

    pids: set = set()    # the roles that hold rows, from each engine
    router = role_router(world, pids)
    for form in ("", "_packed"):
        path = f"{snap}/tiled_role{form}.npz"
        t0 = time.perf_counter()
        tiled = TiledSearcher.from_snapshot(arena, router, path)
        pids.clear()
        pids.update(tiled.part_chunks, tiled._big)
        _sync(device)
        rep[f"tiled{form}_restore_s"] = time.perf_counter() - t0
        (_, ids), rep[f"tiled{form}_first_query_s"] = _first_batch(
            lambda: tiled.search_batch(q, users, world.user_masks, K),
            device)
        rep[f"tiled{form}_ids_sha256"] = _digest(ids)
        if not form:
            rep["total_cold_start_s"] = time.perf_counter() - t_all
    rep["rls_ids_sha256"] = _digest(rls_ids)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="artifacts/cold_start",
                    help="where the snapshots go")
    ap.add_argument("--phase", default="", choices=["", "build", "load"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench.cold_start measures the card: no CUDA device",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if args.phase == "build":
        os.makedirs(args.dir, exist_ok=True)
        print("BUILD " + json.dumps(phase_build(args.dir, device)))
        return 0
    if args.phase == "load":
        print("LOAD " + json.dumps(phase_load(args.dir, device)))
        return 0

    from ..ops import _build
    from .evidence import card

    t0 = time.perf_counter()
    _build.lib()
    out: Dict = {"n": N, "kernel_build_s": time.perf_counter() - t0}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(_ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    for phase in ("build", "load"):
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "vectorsearch_rbac_tpu_torch.bench."
             "cold_start", "--phase", phase, "--dir",
             os.path.abspath(args.dir)], capture_output=True, text=True,
            timeout=1500, cwd=str(_ROOT), env=env)
        sys.stderr.write(p.stderr[-3000:])
        if p.returncode:
            print(p.stdout[-3000:], file=sys.stderr)
            return p.returncode
        for line in p.stdout.splitlines():
            if line.startswith(("BUILD ", "LOAD ")):
                tag, payload = line.split(" ", 1)
                out[tag.lower()] = json.loads(payload)
        out[f"{phase}_process_s"] = time.perf_counter() - t0
    b, ld = out["build"], out["load"]
    out["restored_ids_equal"] = (
        b["rls_ids_sha256"] == ld["rls_ids_sha256"]
        and b["tiled_ids_sha256"] == ld["tiled_ids_sha256"]
        == ld["tiled_packed_ids_sha256"])
    out["rebuild_s"] = (b["arena_build_s"] + b["rls_build_plus_first_query_s"]
                        + b["tiled_build_s"] + b["tiled_first_query_s"])
    out["restore_beats_rebuild"] = ld["total_cold_start_s"] < out["rebuild_s"]
    out["card"] = card()
    print(json.dumps(out))
    return 0 if out["restored_ids_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
