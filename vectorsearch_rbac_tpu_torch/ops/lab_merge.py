"""The kernel lab's y-form merge: subgroup extraction and bitonic sorts on
values that carry their own position.

Counterpart of scripts/r4_extract_kernel.py and scripts/r4_bitonic_kernel.py
(the lab kernels S4 and S5), the alternative to the package's merge
(ops/merge.py merge_topk, K3 + K4, which the lab called v3): the position
of a candidate inside its subgroup of at most 128 groups rides in the low 7
bits of its packed value (y = (score << 7) | pos, the lane bits dropped),
so a survivor is one int32 and no meta word is written.

- `subgroup_extract` (S4): the t smallest y of each subgroup, ascending
  (`y_extract`, its kernel's wrapper, takes any t >= 1);
- `bitonic_sort_keep` (S5, sort form): a column's survivors sorted, the
  first `keep` rows;
- `bitonic_pairs_keep` (S5, pairs form): the same network carrying each
  survivor's global group (row // t) * sub + (y & 127), with the TPU
  network's order of equal y;
- `extract_merge`: S4, then the k smallest y by a stable sort, the global
  groups, and the true packed values gathered back (lab :92-110);
- `extract_merge_v2`: S4 then S5's pairs form and the gather (lab :67-89).

Both merges return ((Q, k) packed values with their lane bits, (Q, k) int32
global group positions): the cascade's contract. The kernels are in
csrc/merge.cu; the plain versions beside the wrappers take CPU tensors.

One fault of the lab is fixed here: its extraction masks a hit with 2^30,
which sorts below the inadmissible 0x7F000000 | pos, so a subgroup with
fewer than t admissible groups emits 2^30 (position 0) round after round
and the merge's gather then returns one real candidate several times. The
port masks with INT32_MAX, as the package's K3 does; where no subgroup runs
out of admissible groups within t rounds the outputs are the lab's, bit for
bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .merge import INT32_MAX, MAX_NPC, bitonic_pairs_plain, merge_topk

MAX_SUB = 128   # the position field is 7 bits

# the lab's v3 (r4_extract_kernel.py:164, :142 and r4_bitonic_kernel.py:184)
# became the package's merge, K3 + K4: the port's is ops/merge.py's
extract_merge_v3 = merge_topk


def _check_y(mins: torch.Tensor, sub: int, t: int) -> None:
    ng = mins.shape[0]
    if not 1 <= sub <= MAX_SUB or ng % sub:
        raise ValueError(f"sub {sub} must be in [1, {MAX_SUB}] (a 7-bit "
                         f"position) and divide n_groups {ng}")
    if t < 1:
        raise ValueError(f"t {t} must be positive")


def _check_extract(mins: torch.Tensor, sub: int, t: int) -> None:
    _check_y(mins, sub, t)
    if t < 8 or t % 8:
        raise ValueError(f"t {t} must be a positive multiple of 8, as the "
                         "lab kernel's output block requires")


def y_extract_plain(mins: torch.Tensor, sub: int, t: int) -> torch.Tensor:
    """Plain version of the y-form extraction at any t >= 1: (n_groups, Q)
    packed minima -> (n_groups / sub * t, Q) y, row j * t + r the r-th
    smallest of subgroup j, INT32_MAX past its sub values. The y of a
    subgroup are distinct, so its sorted prefix is the lab kernel's rounds
    of (min, mask)."""
    _check_y(mins, sub, t)
    ng, nq = mins.shape
    pos = torch.arange(sub, dtype=torch.int32, device=mins.device)
    y = (mins.view(ng // sub, sub, nq) & ~127) | pos[None, :, None]
    y = torch.sort(y, dim=1).values[:, :t]
    if t > sub:
        y = torch.cat([y, y.new_full((ng // sub, t - sub, nq), INT32_MAX)],
                      dim=1)
    return y.reshape(ng // sub * t, nq)


def y_extract(mins: torch.Tensor, sub: int, t: int) -> torch.Tensor:
    """S4's kernel at any t >= 1. CPU tensors take y_extract_plain; CUDA
    tensors launch csrc/merge.cu y_extract_kernel (counted under
    "merge_y_extract")."""
    _check_y(mins, sub, t)
    if mins.device.type == "cpu":
        return y_extract_plain(mins, sub, t)
    if mins.dtype != torch.int32 or not mins.is_contiguous():
        raise ValueError("y_extract takes a contiguous int32 tensor")
    ng, nq = mins.shape
    out = torch.empty((ng // sub * t, nq), dtype=torch.int32,
                      device=mins.device)
    err = _build.lib().vsr_y_extract(mins.data_ptr(), out.data_ptr(), nq,
                                     ng // sub, sub, t,
                                     _build.stream_ptr(mins.device))
    _build.check(err, "vsr_y_extract")
    _build.LAUNCHES["merge_y_extract"] += 1
    return out


def subgroup_extract_plain(mins: torch.Tensor, sub: int = 128,
                           t: int = 16) -> torch.Tensor:
    """Plain version of S4 at the lab's shapes (t a multiple of 8)."""
    _check_extract(mins, sub, t)
    return y_extract_plain(mins, sub, t)


def subgroup_extract(mins: torch.Tensor, sub: int = 128,
                     t: int = 16) -> torch.Tensor:
    """S4 at the lab's shapes (t a multiple of 8). CPU tensors take the
    plain version; CUDA tensors launch the kernel (y_extract)."""
    _check_extract(mins, sub, t)
    return y_extract(mins, sub, t)


def _check_sort(y: torch.Tensor, keep: int) -> None:
    """The shapes the kernel takes: npc a power of two in [2, MAX_NPC],
    1 <= keep <= npc (the TPU lab's keep, a multiple of 8, is one of
    them)."""
    npc = y.shape[0]
    if npc & (npc - 1) or not 2 <= npc <= MAX_NPC or not 1 <= keep <= npc:
        raise ValueError(f"npc {npc} must be a power of two in [2, {MAX_NPC}]"
                         f" and keep {keep} in [1, npc]")


def group_ids(y: torch.Tensor, t: int, sub: int) -> torch.Tensor:
    """(npc, Q) y -> the global group of each survivor: (row // t) * sub +
    (y & 127)."""
    row = torch.arange(y.shape[0], dtype=torch.int32, device=y.device)
    return (row // t * sub)[:, None] + (y & 127)


def bitonic_sort_keep_plain(y: torch.Tensor, keep: int = 128) -> torch.Tensor:
    """Plain version of S5's sort form: each column ascending, the first
    `keep` rows (values only: any sort gives them)."""
    _check_sort(y, keep)
    return torch.sort(y, dim=0).values[:keep]


def bitonic_pairs_keep_plain(y: torch.Tensor, keep: int, t: int,
                             sub: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of S5's pairs form: the TPU network (ops/merge.py
    bitonic_pairs_plain) over (y, group_ids(y))."""
    _check_sort(y, keep)
    return bitonic_pairs_plain(y, group_ids(y, t, sub), keep)


def _bitonic_y(y, keep, t, sub, pairs):
    if y.dtype != torch.int32 or not y.is_contiguous():
        raise ValueError("the y-form bitonic sort takes a contiguous int32 "
                         "tensor")
    npc, nq = y.shape
    out_y = torch.empty((keep, nq), dtype=torch.int32, device=y.device)
    out_g = torch.empty_like(out_y) if pairs else None
    err = _build.lib().vsr_bitonic_y(
        y.data_ptr(), out_y.data_ptr(), out_g.data_ptr() if pairs else None,
        nq, npc, keep, t, sub, int(pairs), _build.stream_ptr(y.device))
    _build.check(err, "vsr_bitonic_y")
    _build.LAUNCHES["merge_y_pairs" if pairs else "merge_y_sort"] += 1
    return out_y, out_g


def bitonic_sort_keep(y: torch.Tensor, keep: int = 128) -> torch.Tensor:
    """S5's sort form. CPU tensors take the plain version; CUDA tensors
    launch csrc/merge.cu bitonic_net_kernel<npc, kValues> ("merge_y_sort")."""
    _check_sort(y, keep)
    if y.device.type == "cpu":
        return bitonic_sort_keep_plain(y, keep)
    return _bitonic_y(y, keep, 1, 1, False)[0]


def bitonic_pairs_keep(y: torch.Tensor, keep: int, t: int,
                       sub: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """S5's pairs form: ((keep, Q) sorted y, (keep, Q) int32 global groups).
    CPU tensors take the plain version; CUDA tensors launch csrc/merge.cu
    bitonic_net_kernel<npc, kGid> ("merge_y_pairs")."""
    _check_sort(y, keep)
    if not 1 <= sub <= MAX_SUB or t < 1:
        raise ValueError(f"sub {sub} must be in [1, {MAX_SUB}], t {t} >= 1")
    if y.device.type == "cpu":
        return bitonic_pairs_keep_plain(y, keep, t, sub)
    return _bitonic_y(y, keep, t, sub, True)


def _gather_packed(mins: torch.Tensor, gpos: torch.Tensor) -> torch.Tensor:
    """(k, Q) global groups -> (Q, k) true packed values of the minima."""
    return mins.gather(0, gpos.long()).T


def extract_merge(mins: torch.Tensor, k: int, sub: int = 128,
                  t: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """S4, then the k smallest survivors of each query by a stable sort
    (lax.top_k's order: equal y, lower row first), their global groups, and
    their true packed values gathered back."""
    y = subgroup_extract(mins, sub, t)                  # (nsub * t, Q)
    srt, sel = torch.sort(y.T, dim=1, stable=True)
    yv, sel = srt[:, :k], sel[:, :k].to(torch.int32)
    gpos = (sel // t) * sub + (yv & 127)                 # (Q, k)
    return _gather_packed(mins, gpos.T), gpos


def extract_merge_v2(mins: torch.Tensor, k: int, sub: int = 128, t: int = 8,
                     keep: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """S4, then S5's pairs form keeps max(keep, k) survivors, and the true
    packed values of the first k are gathered back."""
    y = subgroup_extract(mins, sub, t)
    _, gid = bitonic_pairs_keep(y, max(keep, k), t, sub)
    gk = gid[:k]
    return _gather_packed(mins, gk), gk.T.contiguous()
