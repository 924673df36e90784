"""Group-minima merge: subgroup extraction + bitonic pairs sort.

Counterpart of vectorsearch_rbac_tpu/ops/pallas_merge.py. The two stages
are the hand-written CUDA kernels of csrc/merge.cu (see the note there);
`extract_pairs_plain` and `bitonic_pairs_plain` are their plain PyTorch
versions, used for CPU tensors and as the reference the kernels are
checked against on the card.

Selection contract, the reference's: a true top-k entry is missed only if
more than t of them land in one subgroup of n_groups / nsub groups. At
nsub = 32, t = 16 and k = 100 that is P(X > 16) ~ 1e-8 per subgroup for
X ~ Poisson(k / nsub), whatever n_groups is.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

INT32_MAX = 2**31 - 1
MIN_SUB = 64      # groups per subgroup below which the gate refuses
MAX_NPC = 2048    # survivors the bitonic kernel sorts in one block


def merge_supported(n_groups: int, k: int, nsub: int = 32,
                    t: int = 16) -> bool:
    """Shape gate for the merge kernels, decided from shapes alone before
    any launch. It replaces the reference's merge_supported/_pick_q_tile,
    whose VMEM budgets do not apply to this card. Callers take the exact
    merge where it refuses.

    - the subgroups must tile n_groups evenly;
    - the survivor pool nsub * t must be a power of two the bitonic kernel
      holds in shared memory, and leave 8 slots of headroom over k, as in
      the reference;
    - each subgroup must hold at least MIN_SUB groups, the reference's
      floor: smaller ones make the "more than t top-k entries in one
      subgroup" miss likelier."""
    npc = nsub * t
    return (n_groups % nsub == 0
            and n_groups // nsub >= max(MIN_SUB, t)
            and npc & (npc - 1) == 0 and npc <= MAX_NPC
            and k <= npc - 8)


def extract_pairs_plain(mins: torch.Tensor, nsub: int,
                        t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the extraction kernel: (n_groups, Q) packed minima
    -> ((nsub * t, Q) values, (nsub * t, Q) meta), row j * t + r holding
    subgroup j's r-th extraction. A literal port of the TPU kernel's rounds
    of (min, mask)."""
    ng, nq = mins.shape
    sub = ng // nsub
    m = mins.view(nsub, sub, nq)
    dev = mins.device
    pos = (torch.arange(nsub, dtype=torch.int32, device=dev)[:, None, None]
           * sub + torch.arange(sub, dtype=torch.int32,
                                device=dev)[None, :, None])
    meta = (pos << 7) | (m & 127)
    big = torch.full((), INT32_MAX, dtype=torch.int32, device=dev)
    out_y, out_m = [], []
    for r in range(t):
        cur = m.amin(dim=1, keepdim=True)                # (nsub, 1, Q)
        hit = m == cur
        out_y.append(cur)
        out_m.append(torch.where(hit, meta, big).amin(dim=1, keepdim=True))
        if r + 1 < t:
            m = torch.where(hit, big, m)
    return (torch.cat(out_y, dim=1).reshape(nsub * t, nq),
            torch.cat(out_m, dim=1).reshape(nsub * t, nq))


def extract_pairs(mins: torch.Tensor, nsub: int,
                  t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1. CPU tensors take the plain version; CUDA tensors launch
    csrc/merge.cu extract_pairs_kernel."""
    ng, nq = mins.shape
    if ng % nsub:
        raise ValueError(f"n_groups {ng} is not a multiple of nsub {nsub}")
    if mins.device.type == "cpu":
        return extract_pairs_plain(mins, nsub, t)
    if mins.dtype != torch.int32 or not mins.is_contiguous():
        raise ValueError("extract_pairs takes a contiguous int32 tensor")
    out_y = torch.empty((nsub * t, nq), dtype=torch.int32, device=mins.device)
    out_m = torch.empty_like(out_y)
    err = _build.lib().vsr_extract_pairs(
        mins.data_ptr(), out_y.data_ptr(), out_m.data_ptr(), nq, nsub,
        ng // nsub, t, _build.stream_ptr(mins.device))
    _build.check(err, "vsr_extract_pairs")
    _build.LAUNCHES["merge_extract"] += 1
    return out_y, out_m


def bitonic_pairs_plain(y: torch.Tensor, g: torch.Tensor,
                        keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the bitonic kernel: sort each column of (npc, Q) by
    value with meta riding along, keep the first `keep` rows. A literal port
    of the TPU network, including its compare-exchange, which swaps equal
    values in descending blocks."""
    npc, nq = y.shape
    size = 2
    while size <= npc:
        stride = size // 2
        while stride >= 1:
            nb = npc // (2 * stride)
            y4 = y.reshape(nb, 2, stride, nq)
            g4 = g.reshape(nb, 2, stride, nq)
            a, b = y4[:, 0], y4[:, 1]
            ga, gb = g4[:, 0], g4[:, 1]
            le = a <= b
            lo, hi = torch.where(le, a, b), torch.where(le, b, a)
            glo, ghi = torch.where(le, ga, gb), torch.where(le, gb, ga)
            bidx = torch.arange(nb, device=y.device)[:, None, None]
            desc = ((bidx * (2 * stride)) & size) != 0
            y = torch.stack([torch.where(desc, hi, lo),
                             torch.where(desc, lo, hi)], dim=1).reshape(npc, nq)
            g = torch.stack([torch.where(desc, ghi, glo),
                             torch.where(desc, glo, ghi)], dim=1).reshape(npc, nq)
            stride //= 2
        size *= 2
    return y[:keep], g[:keep]


def bitonic_pairs(y: torch.Tensor, meta: torch.Tensor,
                  keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2. CPU tensors take the plain version; CUDA tensors launch
    csrc/merge.cu bitonic_pairs_kernel."""
    npc, nq = y.shape
    if npc & (npc - 1) or meta.shape != y.shape or not 1 <= keep <= npc:
        raise ValueError(f"bitonic_pairs: npc {npc} must be a power of two, "
                         f"meta {tuple(meta.shape)} match it, keep {keep}")
    if y.device.type == "cpu":
        return bitonic_pairs_plain(y, meta, keep)
    for t in (y, meta):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("bitonic_pairs takes contiguous int32 tensors")
    if npc > MAX_NPC:
        raise ValueError(f"npc {npc} exceeds the kernel's {MAX_NPC}")
    out_y = torch.empty((keep, nq), dtype=torch.int32, device=y.device)
    out_m = torch.empty_like(out_y)
    err = _build.lib().vsr_bitonic_pairs(
        y.data_ptr(), meta.data_ptr(), out_y.data_ptr(), out_m.data_ptr(),
        nq, npc, keep, _build.stream_ptr(y.device))
    _build.check(err, "vsr_bitonic_pairs")
    _build.LAUNCHES["merge_bitonic"] += 1
    return out_y, out_m


def merge_topk(mins: torch.Tensor, k: int, nsub: int = 32,
               t: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_groups, Q) packed minima -> ((Q, k) packed values ascending,
    (Q, k) int32 global group positions): the reference's pallas_merge_topk.
    Positions are meaningful only where the value is below 0x7E000000."""
    npc = nsub * t
    if not k <= npc:
        raise ValueError(f"k {k} exceeds the survivor pool {npc}")
    y, meta = extract_pairs(mins, nsub, t)
    keep = min(npc, max(8 * ((k + 7) // 8), 8))
    ys, ms = bitonic_pairs(y, meta, keep)
    return ys[:k].T, (ms[:k] >> 7).T
