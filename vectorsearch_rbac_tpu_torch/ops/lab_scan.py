"""The kernel lab's scan variants: S1's trim and floor on K1's own
tensor-core schedule, the reference K1's epilogue chain beside trim as its
control, and the first port's dp4a K1.

Counterpart of scripts/r4_kernel_variants.py `int8_masked_topk_lab` (the
lab kernel S1), which times two restructured epilogues of the narrow scan
(ops/scan_int8.py int8_group_minima) on the same inputs:

- "trim" folds the `<< 7` pack into the score arithmetic. On this card
  that fold is K1's own epilogue (csrc/scan_int8.cu pack<kFold>: one
  multiply-add over a per-row base shifted in advance; with a score shift
  K1's shifted form), so trim launches K1's tensor-core kernel on
  per-query masks: K1's minima, by K1's instructions;
- "chain" is trim's control on the same schedule: the reference K1's
  literal epilogue (vectorsearch_rbac_tpu/ops/pallas_scan_int8.py:74-97),
  per pair `score = (l2 ? norms - 2 dots : -dots) >> shift`, then
  `(score << 7) | lane` (csrc/scan_int8.cu kChain). Its output is K1's,
  bit for bit; its time less trim's is what the fold saves;
- "dp4a" is the first port's K1 (d_pad / 4 __dp4a a pair, one thread per
  query): K1's packed minima, bit for bit, by the old design, for the old
  design's time beside the new K1;
- "floor" is a lower-bound probe, not a correct kernel: the min over each
  group of (dots + admit), where admit is the number of roles the row and
  the query share (the TPU lab's one-hot matmul count: the popcount of the
  AND summed over the bitset words). No score, no pack, no mask. It runs
  as a template form of K1's tensor-core kernel (csrc/scan_int8.cu
  kFloor: the dots by wgmma, the count by binary mma.sync, both on the
  tensor cores), so K1's time less the floor's is what K1's epilogue
  costs on K1's own schedule.

The floor and the chain are template forms of the tensor-core kernel (a
run-time flag cost the dp4a kernel 12% on an NVIDIA H100 80GB HBM3 at
700.00 W); every variant takes per-query masks, as the lab's, and no
serving path reaches them.
The lab's `unroll` and `chunk` knobs schedule Mosaic's loop and size its
VMEM chunk: they have no counterpart on this card and are not carried
over. The plain versions are here beside the wrappers; CPU tensors take
them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .scan import exact_f32_matmul
from .scan_int8 import (NARROW_MAX_D, _check_kernel_tensors,
                        _check_scan_args, exact_dots, int8_group_minima_plain,
                        merge_group_minima)

# the C entry's variant codes
VARIANTS = {"dp4a": 0, "trim": 1, "floor": 2, "chain": 3}
LAB_MAX_WORDS = 8                    # the lab's forms: 256 roles
_CHUNK_ELEMS = 1 << 26               # floor plain: elements per temporary


def onehot_bits(bits: torch.Tensor) -> torch.Tensor:
    """(n, W) int32 bitsets -> (n, 32 W) float32 0/1 (bit b of word w is
    column 32 w + b: core.bits_to_onehot8's order)."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    return ((bits[:, :, None] >> shifts) & 1).reshape(bits.shape[0], -1).to(
        torch.float32)


def floor_minima_plain(queries_q, vectors_q, norms_q, role_bits, query_bits,
                       group: int = 128) -> torch.Tensor:
    """Plain version of the floor probe: (n_groups, Q) int32 min over each
    group of dots + shared-role count. The count is a float32 matmul of
    the role one-hots (exact: at most 256)."""
    _check_scan_args(queries_q, vectors_q, norms_q, role_bits, query_bits,
                     group)
    nq = queries_q.shape[0]
    npad = vectors_q.shape[0]
    qf = queries_q.to(torch.float32)
    qroles = onehot_bits(query_bits)
    chunk = max(group, min(npad, (_CHUNK_ELEMS // max(nq, 1)) // group * group))
    out = torch.empty((npad // group, nq), dtype=torch.int32,
                      device=queries_q.device)
    with exact_f32_matmul():
        for r0 in range(0, npad, chunk):
            r1 = min(r0 + chunk, npad)
            count = (onehot_bits(role_bits[r0:r1]) @ qroles.T).to(torch.int32)
            val = exact_dots(vectors_q[r0:r1], qf) + count
            out[r0 // group:r1 // group] = val.view(-1, group, nq).amin(dim=1)
    return out


def lab_group_minima(queries_q, vectors_q, norms_q, role_bits, query_bits,
                     group: int = 128, metric: str = "l2",
                     score_shift: int = 0,
                     variant: str = "trim") -> torch.Tensor:
    """(n_groups, Q) int32 minima of the lab's `variant` (all but "floor":
    K1's packed minima; "floor": the probe, which reads neither `metric`
    nor `score_shift`). Operands as ops/scan_int8.int8_group_minima's with
    per-query masks, d_pad 128 or 256, W 1-8. CPU tensors take the plain
    versions (all but floor's are K1's); CUDA tensors launch the variant
    (counted under "scan_int8_<variant>"): trim, chain and floor on the
    tensor-core kernel (K1's per-query form, its chain and floor forms),
    dp4a on the dp4a kernel."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of "
                         f"{tuple(VARIANTS)}")
    if queries_q.shape[1] > NARROW_MAX_D:
        raise ValueError(f"d_pad {queries_q.shape[1]}: the lab variants are "
                         "the narrow scan's (d_pad <= 256)")
    if queries_q.device.type == "cpu":
        if variant == "floor":
            return floor_minima_plain(queries_q, vectors_q, norms_q,
                                      role_bits, query_bits, group)
        return int8_group_minima_plain(queries_q, vectors_q, norms_q,
                                       role_bits, query_bits, group, metric,
                                       score_shift)
    _check_scan_args(queries_q, vectors_q, norms_q, role_bits, query_bits,
                     group)
    nq, d_pad = queries_q.shape
    npad, w = vectors_q.shape[0], role_bits.shape[1]
    if d_pad not in (128, 256):
        raise ValueError(f"d_pad {d_pad}: the narrow scan takes d_pad 128 or "
                         "256")
    tensors = (queries_q, vectors_q, norms_q, role_bits, query_bits)
    _check_kernel_tensors(tensors, w, LAB_MAX_WORDS)
    out = torch.empty((npad // group, nq), dtype=torch.int32,
                      device=queries_q.device)
    err = _build.lib().vsr_scan_int8_lab(
        *(t.data_ptr() for t in tensors), out.data_ptr(), nq, npad, d_pad, w,
        group, int(metric == "l2"), score_shift, VARIANTS[variant],
        _build.stream_ptr(queries_q.device))
    _build.check(err, "vsr_scan_int8_lab")
    _build.LAUNCHES[f"scan_int8_{variant}"] += 1
    return out


def int8_masked_topk_lab(queries_q, query_norms, vectors_q, norms_q,
                         role_bits, query_bits, inv_scale_sq, k: int,
                         group: int = 128, merge: str = "cascade",
                         metric: str = "l2", query_bias=None,
                         score_shift: int = 0, variant: str = "trim"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lab's int8_masked_topk_lab: the variant's minima, then
    merge_group_minima's `merge` (the lab's default is the cascade), or with
    merge="none" the raw (n_groups, Q) minima twice, as the lab returns
    them. Operands as ops/scan_int8.int8_masked_topk's."""
    packed = lab_group_minima(queries_q, vectors_q, norms_q, role_bits,
                              query_bits, group, metric, score_shift, variant)
    if merge == "none":
        return packed, packed
    return merge_group_minima(packed, query_norms, inv_scale_sq, k, group,
                              merge, metric, score_shift, query_bias)
