"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: every test skips without a CUDA device. On a GPU machine,
from the checkout's root (this file imports no jax, so the repository's
conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda_kernels.py

The shapes here are small and deliberately ragged (query counts that fill
no block, every group width, 1-8 bitset words, d_pad 256, the ip metric,
a score shift, ties everywhere) to reach the corners the main-path run in
chip_smoke.py does not."""

import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu_torch.ops import _build, merge, scan_int8

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scan_inputs(rng, dev, nq, npad, d_pad, w):
    x8 = rng.integers(-128, 128, size=(npad, d_pad)).astype(np.int8)
    q8 = rng.integers(-128, 128, size=(nq, d_pad)).astype(np.int8)
    norms = np.einsum("nd,nd->n", x8.astype(np.int64),
                      x8.astype(np.int64)).astype(np.int32)
    rbits = (rng.random((npad, w * 32)) < 0.05)
    qbits = (rng.random((nq, w * 32)) < 0.1)
    pack = lambda b: np.packbits(b, axis=1, bitorder="little").view(np.int32)
    qb = pack(qbits)
    qb[0] = 0                                   # one query sees nothing
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(q8), t(x8), t(norms), t(pack(rbits)), t(qb)


@pytest.mark.parametrize("nq,npad,d_pad,w,group,metric,shift", [
    (1, 1024, 128, 4, 128, "l2", 0),
    (37, 1152, 128, 1, 8, "l2", 0),
    (300, 2048, 128, 8, 32, "ip", 0),
    (257, 1280, 256, 2, 64, "l2", 3),
    (2048, 8192, 128, 4, 128, "l2", 0),
])
def test_scan_kernel_bit_identical(dev, nq, npad, d_pad, w, group, metric,
                                   shift):
    args = _scan_inputs(np.random.default_rng(nq), dev, nq, npad, d_pad, w)
    before = _build.LAUNCHES["scan_int8"]
    got = scan_int8.int8_group_minima(*args, group=group, metric=metric,
                                      score_shift=shift)
    assert _build.LAUNCHES["scan_int8"] == before + 1
    want = scan_int8.int8_group_minima_plain(*args, group=group,
                                             metric=metric,
                                             score_shift=shift)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (got[:, 0] == scan_int8.MASKED_I32).all()


def _packed_with_ties(rng, ng, nq):
    p = rng.integers(1 << 10, (1 << 10) + 24, size=(ng, nq)).astype(np.int32)
    p = (p << 7) | rng.integers(0, 4, size=(ng, nq)).astype(np.int32)
    p[rng.random((ng, nq)) < 0.3] = scan_int8.MASKED_I32
    p[:, 1] = scan_int8.MASKED_I32              # a column with nothing
    return p


@pytest.mark.parametrize("ng,nq,nsub,t", [(2048, 300, 32, 16),
                                          (512, 40, 8, 8),
                                          (8192, 129, 32, 16)])
def test_extract_kernel_identical(dev, ng, nq, nsub, t):
    p = torch.from_numpy(_packed_with_ties(np.random.default_rng(ng), ng,
                                           nq)).to(dev)
    y, meta = merge.extract_pairs(p, nsub, t)
    y_p, meta_p = merge.extract_pairs_plain(p, nsub, t)
    torch.cuda.synchronize()
    assert torch.equal(y, y_p)
    assert torch.equal(meta, meta_p)   # drained rounds included


@pytest.mark.parametrize("npc,nq,keep", [(64, 33, 16), (512, 300, 104),
                                         (2048, 17, 2048)])
def test_bitonic_kernel_identical(dev, npc, nq, keep):
    rng = np.random.default_rng(npc)
    y = torch.from_numpy(rng.integers(0, 40, size=(npc, nq)).astype(
        np.int32)).to(dev)
    g = torch.from_numpy(rng.integers(0, 1 << 20, size=(npc, nq)).astype(
        np.int32)).to(dev)
    ys, gs = merge.bitonic_pairs(y, g, keep)
    ys_p, gs_p = merge.bitonic_pairs_plain(y, g, keep)
    torch.cuda.synchronize()
    assert torch.equal(ys, ys_p) and torch.equal(gs, gs_p)
    assert (ys[1:] >= ys[:-1]).all()


def test_masked_topk_cuda_equals_cpu(dev):
    args = _scan_inputs(np.random.default_rng(9), dev, 260, 16384, 128, 4)
    qn = (args[0].to(torch.int32) ** 2).sum(dim=1, dtype=torch.int32)
    assert merge.merge_supported(16384 // 8, 10)
    d, i = scan_int8.int8_masked_topk(args[0], qn, *args[1:], 1.0, 10,
                                      group=8)
    cpu = [a.cpu() for a in args]
    d_c, i_c = scan_int8.int8_masked_topk(cpu[0], qn.cpu(), *cpu[1:], 1.0,
                                          10, group=8)
    assert torch.equal(i.cpu(), i_c) and torch.equal(d.cpu(), d_c)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    args = _scan_inputs(np.random.default_rng(1), dev, 8, 1024, 384, 1)
    with pytest.raises(NotImplementedError, match="wide"):
        scan_int8.int8_group_minima(*args)
    args = _scan_inputs(np.random.default_rng(1), dev, 8, 1024, 128, 9)
    with pytest.raises(ValueError):
        scan_int8.int8_group_minima(*args)
    y = torch.zeros((4096, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        merge.bitonic_pairs(y, y, 8)
