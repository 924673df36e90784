"""IVF coverage-family validation on the card: IVF probe recall and time
fitted on even nprobe points, scored on the held-out odd ones.

    python -m vectorsearch_rbac_tpu_torch.bench.ivf_coverage
        [--sizes N [N ...]] [--checkpoint PATH] [--device cuda|cpu]

The port's runner for scripts/ivf_coverage_validation.py (all of it,
:79-169): sift_like_corpus(1,000,000 x 128, 100 blocks a document, seed
0), the selectivity lab world (selectivities 0.05 / 0.1 / 0.25 / 0.5,
seed 1) on a float32 arena of 65,536-row blocks, 256 queries drawn by
default_rng(2) from the pool; for each size (250,000, then 1,000,000) a
sorted random row subset from the same generator and an IVFIndex over it
(nlist max(64, int(sqrt(size))), query_batch 256, seed 0); for each
selectivity the exact top-10 of the subset by the script's formula
(sum x^2 - 2 q.x over the user's readable rows, float32, TF32 off, in
stable order: exact on the integer SIFT rows) and the nprobe sweep 4, 6,
8, 12, 16, 24, 32, 48, 64, 96, 128 (one warm pass, then 2 timed: host
seconds a query; IVFIndex reads each batch's routing back to the host,
so the time carries that sync). On the even sweep points it fits the
time line log(size) (a nprobe l_pad + b) and the coverage family
(models/fitting.py fit_ivf_coverage); on the odd ones it scores recall
MAE and time MAPE. Every returned row must be readable by its user.

Each cell is checkpointed to --checkpoint (state/ivf_coverage.json) as it
is measured, and a rerun skips the measured ones (a size whose cells are
all measured builds no index); --sizes runs some sizes only, so that the
grid can be split across calls. Prints one JSON line: the keys of
results/ivf_coverage_validation_1m.json, "hardware" holding the card's
nvidia-smi name and power limit. Exits 2 without CUDA unless given
--device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import build_device_arena
from ..data import sift_like_corpus
from ..index.ivf import IVFIndex
from ..models.fitting import fit_ivf_coverage
from ..models.validate import selectivity_lab_world
from ..ops.scan import exact_f32_matmul
from . import evidence

N = 1_000_000
SELS = [0.05, 0.1, 0.25, 0.5]
SIZES = [250_000, 1_000_000]
NPROBES = [4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128]
TOPK = 10
NQ = 256
HNSW_FAMILY_MAE = 0.044   # the TPU record's HNSW family MAE the script cites
CHECKPOINT = os.path.join("state", "ivf_coverage.json")


def subset_truth(corpus, rows: np.ndarray, allowed: np.ndarray,
                 queries: np.ndarray, k: int, device) -> np.ndarray:
    """The script's exact top-k of `rows` (:102-111): sum x^2 - 2 q.x with
    the unreadable rows at +inf, in stable order, -1 where a query has
    fewer than k readable rows; the products on `device`."""
    sub_vec = corpus.vectors[rows]
    sub_norm = np.einsum("nd,nd->n", sub_vec, sub_vec)
    x = torch.from_numpy(np.ascontiguousarray(sub_vec, np.float32)).to(device)
    nrm = torch.from_numpy(sub_norm).to(device)
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(device)
    with exact_f32_matmul():
        d2 = nrm[None, :] - 2.0 * (q @ x.T)
    d2[:, ~torch.from_numpy(allowed).to(device)] = torch.inf
    vals, order = torch.sort(d2, dim=1, stable=True)
    order, vals = order[:, :k].cpu().numpy(), vals[:, :k].cpu().numpy()
    truth = rows[order]
    truth[vals == np.inf] = -1
    return truth


def coverage_cell(idx: IVFIndex, corpus, arena, rows: np.ndarray,
                  bits: np.ndarray, mask: np.ndarray, sel: float,
                  queries: np.ndarray, nprobes: Sequence[int] = NPROBES
                  ) -> Dict:
    """One (size, selectivity) cell: the sweep, the fit on the even points
    and the errors on the odd ones (:104-150)."""
    size, nq = len(rows), len(queries)
    masks = np.tile(mask, (nq, 1))
    allowed = (bits[rows] & mask).any(axis=1)
    truth = subset_truth(corpus, rows, allowed, queries, TOPK, arena.device)
    recalls, times = [], []
    for npb in nprobes:
        idx.search(queries, masks, TOPK, nprobe=npb)  # warm
        t0 = time.perf_counter()
        for _ in range(2):
            d, i = idx.search(queries, masks, TOPK, nprobe=npb)
        dt = (time.perf_counter() - t0) / (2 * nq)
        evidence.readable_or_raise(f"ivf n={size} sel={sel} nprobe={npb}",
                                   i, masks, arena.host_bits)
        hit = (i[:, :, None] == truth[:, None, :]) & (truth >= 0)[:, None, :]
        denom = np.maximum((truth >= 0).sum(axis=1), 1)
        recalls.append(float((hit.any(axis=1).sum(axis=1) / denom).mean()))
        times.append(dt)
    l_pad = size / idx.nlist
    xe = np.array(nprobes, dtype=np.float64)[::2] * l_pad
    ye = np.array(times, dtype=np.float64)[::2] / np.log(size)
    A = np.vstack([xe, np.ones_like(xe)]).T
    (a_fit, b_fit), *_ = np.linalg.lstsq(A, ye, rcond=None)
    fit = fit_ivf_coverage(np.array(nprobes)[::2], np.array(recalls)[::2],
                           l_pad=l_pad, a=max(float(a_fit), 1e-12),
                           b=max(float(b_fit), 0.0))
    pred = [fit.recall(npb) for npb in nprobes]
    held = [abs(pred[j] - recalls[j]) for j in range(1, len(nprobes), 2)]
    pred_t = [fit.partition_time(size, npb) for npb in nprobes]
    mape = float(np.mean([abs(pred_t[j] - times[j]) / max(times[j], 1e-12)
                          for j in range(1, len(nprobes), 2)]))
    return {"n": int(size), "sel": float(sel), "nprobes": list(nprobes),
            "measured_recall": [round(r, 4) for r in recalls],
            "predicted_recall": [round(p, 4) for p in pred],
            "measured_time_s": times,
            "heldout_recall_mae": round(float(np.mean(held)), 4),
            "time_mape": round(mape, 3),
            "fit": fit.to_dict()}


def run(device, n: int = N, sels: Sequence[float] = SELS,
        sizes: Sequence[int] = SIZES, nprobes: Sequence[int] = NPROBES,
        nq: int = NQ, only: Optional[Sequence[int]] = None,
        cells: Optional[List[Dict]] = None,
        checkpoint: Optional[str] = None) -> Dict:
    """The grid (the sizes in `only`, all by default) after the measured
    `cells`; the record."""
    corpus, qpool = sift_like_corpus(num_vectors=n, blocks_per_doc=100,
                                     seed=0)
    world = selectivity_lab_world(corpus.num_docs, sels, seed=1)
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=65536)
    bits = corpus.vector_role_bits(world)
    rng = np.random.default_rng(2)
    queries = qpool[rng.choice(len(qpool), nq, replace=False)].astype(
        np.float32)
    out = {"config": f"IVF coverage family validation: {list(sizes)} x "
                     f"{list(sels)} x nprobe {list(nprobes)}, clustered "
                     f"sift-like {n / 1e6:g}M, top-{TOPK}, fit "
                     "(recall family AND time a,b) on even sweep points / "
                     "MAE+MAPE on held-out odd points",
           "cells": list(cells or [])}
    for size in sizes:
        rows = np.sort(rng.choice(corpus.n, size, replace=False))
        done = {(c["n"], c["sel"]) for c in out["cells"]}
        todo = [(si, s) for si, s in enumerate(sels)
                if (size, float(s)) not in done]
        if not todo or (only and size not in only):
            continue
        t0 = time.perf_counter()
        idx = IVFIndex(arena, rows=rows, nlist=max(64, int(np.sqrt(size))),
                       query_batch=nq, seed=0)
        build_s = time.perf_counter() - t0
        print(f"ivf n={size} nlist={idx.nlist} l_pad={idx.l_pad} built "
              f"{build_s:.1f}s", file=sys.stderr, flush=True)
        for si, sel in todo:
            cell = coverage_cell(idx, corpus, arena, rows, bits,
                                 world.user_masks[si], sel, queries, nprobes)
            cell.update(nlist=idx.nlist, l_pad=idx.l_pad, build_s=build_s)
            out["cells"].append(cell)
            print(f"n={size} sel={sel}: heldout MAE "
                  f"{cell['heldout_recall_mae']}  time MAPE "
                  f"{cell['time_mape']:.2f}  recall@{nprobes[-1]} "
                  f"{cell['measured_recall'][-1]:.3f}", file=sys.stderr,
                  flush=True)
            evidence.save_checkpoint(checkpoint, out)
        del idx
    out["heldout_recall_mae"] = round(float(np.mean(
        [c["heldout_recall_mae"] for c in out["cells"]])), 4)
    out["time_mape"] = round(float(np.mean(
        [c["time_mape"] for c in out["cells"]])), 3)
    out["hnsw_family_reference_mae"] = HNSW_FAMILY_MAE
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=None,
                    choices=SIZES, help="only these sizes")
    ap.add_argument("--checkpoint", default=CHECKPOINT,
                    help=f"the cells measured so far (default {CHECKPOINT})")
    evidence.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = evidence.resolve_device(args.device, "bench.ivf_coverage")
    if device is None:
        return 2
    prev = evidence.load_checkpoint(args.checkpoint) or {}
    if prev.get("cells"):
        print(f"resuming: {len(prev['cells'])} cells checkpointed",
              file=sys.stderr)
    out = run(device, only=args.sizes, cells=prev.get("cells"),
              checkpoint=args.checkpoint)
    out["hardware"] = evidence.hardware(device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
