"""Artifact persistence: pickles, npz state, arena snapshots and fitted
cost-model parameters.

Counterpart of vectorsearch_rbac_tpu/utils/persist.py, with the same
functions and file layouts:

- worlds, plans and trees: pickles (`save_pickle` / `load_pickle`). The
  port pickles its own classes and never loads the reference's pickles,
  which would import the reference package;
- HNSW graphs (`HNSWIndex.graph_state()`) and other array state: npz
  (`save_npz` / `load_npz`, a JSON `__meta__` entry beside the arrays);
- the int8 serving arena (`save_arena_snapshot` / `load_arena_snapshot`):
  no corpus and no quantization at restore;
- fitted parameters: JSON with a `family` tag (`save_params` /
  `load_params`).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict

import numpy as np
import torch


def _ensure_dir(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def save_pickle(obj: Any, path: str) -> None:
    _ensure_dir(path)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_npz(state: Dict[str, np.ndarray], path: str, **meta) -> None:
    _ensure_dir(path)
    np.savez_compressed(path, __meta__=json.dumps(meta), **state)


def load_npz(path: str):
    """(state dict of arrays, meta dict)."""
    with np.load(path, allow_pickle=False) as data:
        meta = (json.loads(str(data["__meta__"]))
                if "__meta__" in data.files else {})
        state = {k: data[k] for k in data.files if k != "__meta__"}
    return state, meta


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> the uint16 bits of its bfloat16 rounding (torch's, as the
    arena's device mirror rounds)."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bf16_values(bits: np.ndarray) -> np.ndarray:
    """The uint16 bits of bfloat16 values -> float32 (exact)."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(
        torch.bfloat16).to(torch.float32).numpy()


def save_arena_snapshot(arena, path: str, with_mirror: bool = None) -> None:
    """Save an int8 serving arena so that load_arena_snapshot rebuilds it
    without the corpus and without quantizing: the int8 codes and their
    norms, the role bitsets (tombstones included), the float32 norms, the
    row ids and the quantization parameters. The full-precision rows ride
    as bfloat16 bits only where the quantization is lossy (with_mirror
    None); a lossless arena's rows are the codes dequantized exactly, so a
    SIFT-shaped 1M arena saves ~170 MB. Uncompressed npz: int8 codes
    barely compress, and the load is the disk read and the upload."""
    q = arena.quant
    if q is None:
        raise ValueError("arena snapshots take the int8 serving arena")
    _ensure_dir(path)
    if with_mirror is None:
        with_mirror = not q.lossless
    state = dict(
        vq=q.vectors_q.cpu().numpy(), nq=q.norms_q.cpu().numpy(),
        bits=np.ascontiguousarray(arena.host_bits, np.uint32),
        norms=np.asarray(arena.host_norms, np.float32),
        doc_ids=arena.doc_ids, block_ids=arena.block_ids,
        center=q.center.astype(np.float32))
    if with_mirror:
        state["mirror_bf16"] = _bf16_bits(arena.host_vectors)
    np.savez(path, __meta__=json.dumps(dict(
        n=int(arena.n), metric=arena.metric, scale=float(q.scale),
        qclip=int(q.qclip), lossless=bool(q.lossless),
        with_mirror=bool(with_mirror))), **state)


def load_arena_snapshot(path: str, device):
    """save_arena_snapshot's file -> a DeviceArena on `device`. The float32
    host mirror (which the graph builders read) is the dequantized codes
    for a lossless arena, equal to a built arena's, and the bfloat16
    mirror's values for a lossy one: host code that needs the exact float32
    rows of a lossy corpus recomputes them from the corpus. The device
    tensors equal a built arena's either way."""
    from ..core import _assemble

    state, meta = load_npz(path)
    vq, center = state["vq"], state["center"]
    scale, n = float(meta["scale"]), int(meta["n"])
    if meta.get("with_mirror"):
        host_vec = _bf16_values(state["mirror_bf16"])
    else:
        d = len(center)
        host_vec = vq[:, :d].astype(np.float32) / np.float32(scale) \
            + center[None, :]
        host_vec[n:] = 0.0   # pad rows are zero, not the center
    return _assemble(
        host_vec, state["norms"], state["bits"], n, state["doc_ids"],
        state["block_ids"],
        (vq, state["nq"], scale, center, bool(meta["lossless"]),
         int(meta["qclip"])),
        meta.get("metric", "l2"), device, torch.bfloat16)


def save_params(params, path: str) -> None:
    """Fitted cost-model parameters as JSON, with a `family` tag naming
    their class for load_params (one parameter_<index>.json an index)."""
    from ..models.cost import IVFCoverageParams, TPUCostParams

    _ensure_dir(path)
    d = params.to_dict()
    d["family"] = ("ivf_coverage" if isinstance(params, IVFCoverageParams)
                   else "tpu" if isinstance(params, TPUCostParams)
                   else "reference")
    with open(path, "w") as f:
        json.dump(d, f, indent=2)


def load_params(path: str):
    from ..models.cost import (CostModelParams, IVFCoverageParams,
                               TPUCostParams)

    with open(path) as f:
        d = json.load(f)
    fam = d.pop("family", "reference")
    cls = {"ivf_coverage": IVFCoverageParams,
           "tpu": TPUCostParams}.get(fam, CostModelParams)
    return cls.from_dict(d)
