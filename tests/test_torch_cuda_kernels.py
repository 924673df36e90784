"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: every test skips without a CUDA device. On a GPU machine,
from the checkout's root (this file imports no jax, so the repository's
conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda_kernels.py

The shapes here are small and deliberately ragged (query counts that fill
no block, every group width, 1-8 bitset words, the wide-world forms'
9, 16 and 32 and the huge forms' 33-128, d_pad 256 and the wide 384-768, the ip metric, score
shifts, ties everywhere, both slot layouts of the admit-dedup form) to
reach the corners the main-path runs in chip_smoke.py do not."""

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
    # the tensor-core tile's corners: query counts that fill no 64- or
    # 256-query tile, W 1-8, every group, d_pad 256, shifts 0, 3 and 9
    # (the packing past 7), runs of row tiles that wrap the ring (1 query:
    # one run per SM of 7-8 tiles; 2047: 16 runs of 12-13) or end unevenly
    (1, 128000, 128, 3, 16, "ip", 9),
    (37, 1152, 256, 5, 8, "l2", 3),
    (65, 4736, 128, 6, 64, "l2", 9),
    (65, 2048, 128, 1, 32, "l2", 3),
    (129, 140800, 256, 7, 32, "ip", 0),
    (2047, 25600, 128, 2, 128, "l2", 3),
    (2047, 4736, 256, 8, 16, "ip", 9),
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


@pytest.mark.parametrize("nq,npad,d_pad,w,group,metric,shift", [
    (1, 128, 384, 1, 128, "l2", 2),
    (37, 1152, 384, 4, 8, "ip", 0),
    (65, 1024, 512, 8, 16, "l2", 1),
    (130, 2048, 768, 2, 32, "ip", 3),
    (300, 1280, 768, 3, 64, "l2", 3),
    (2048, 8192, 768, 4, 128, "ip", 3),
    # the tensor-core tile's corners: d_pad 384-768, every group width, W
    # 1-8, query counts that fill no 128-query tile
    (1, 256, 384, 1, 8, "l2", 0),
    (37, 1152, 512, 2, 16, "ip", 1),
    (65, 1024, 640, 3, 32, "l2", 3),
    (130, 2048, 768, 5, 64, "ip", 3),
    (2048, 4096, 768, 8, 128, "ip", 3),
    (2048, 2048, 640, 6, 8, "l2", 7),
    (129, 1024, 512, 3, 16, "l2", 9),      # shifts past 7: the kernel's
    (40, 1024, 768, 6, 32, "ip", 12),      # other packing path
    # d_pad 128 and 256, where the narrow kernel serves and K2 is its
    # yardstick (chip_smoke.py phase 3)
    (1, 1024, 128, 4, 128, "l2", 0),
    (300, 2048, 256, 8, 32, "ip", 1),
    (2047, 4096, 128, 3, 8, "l2", 9),
])
def test_wide_scan_kernel_bit_identical(dev, nq, npad, d_pad, w, group,
                                        metric, shift):
    args = _scan_inputs(np.random.default_rng(nq), dev, nq, npad, d_pad, w)
    before = dict(_build.LAUNCHES)
    # rows of 256 or less route to the narrow kernel: K2 is called by name
    scan = (scan_int8.int8_group_minima if d_pad > scan_int8.NARROW_MAX_D
            else scan_int8.int8_group_minima_wide)
    got = scan(*args, group=group, metric=metric, score_shift=shift)
    assert _build.LAUNCHES["scan_int8_wide"] == before["scan_int8_wide"] + 1
    assert _build.LAUNCHES["scan_int8"] == before["scan_int8"]
    want = scan_int8.int8_group_minima_wide_plain(
        *args, group=group, metric=metric, score_shift=shift)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (got[:, 0] == scan_int8.MASKED_I32).all()


@pytest.mark.parametrize("d_pad,group", [(128, 8), (256, 32)])
def test_scan_kernel_extreme_operands(dev, d_pad, group):
    """K1 with every product at its extreme (-128 * -128 and -128 * 127):
    the tensor cores' signed int8 and exact int32 sums, l2 at shift 0,
    where the packed scores come closest to the int32 range."""
    nq, npad = 70, 512
    x = np.full((npad, d_pad), -128, np.int8)
    x[1::2] = 127
    q = np.full((nq, d_pad), -128, np.int8)
    q[::3, ::2] = 127
    norms = np.einsum("nd,nd->n", x.astype(np.int64),
                      x.astype(np.int64)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    bits = t(np.full((npad, 1), -1, np.int32))
    args = (t(q), t(x), t(norms), bits, t(np.full((nq, 1), 1, np.int32)))
    before = _build.LAUNCHES["scan_int8"]
    got = scan_int8.int8_group_minima(*args, group=group, metric="l2")
    assert _build.LAUNCHES["scan_int8"] == before + 1
    want = scan_int8.int8_group_minima_plain(*args, group=group,
                                             metric="l2")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_wide_kernel_extreme_operands(dev):
    """Every product at its extreme (-128 * -128 and -128 * 127): the
    tensor cores' signed int8 and exact int32 sums, l2 at shift 0."""
    nq, npad, d_pad = 70, 512, 768
    x = np.full((npad, d_pad), -128, np.int8)
    x[1::2] = 127
    q = np.full((nq, d_pad), -128, np.int8)
    q[::3, ::2] = 127
    norms = np.einsum("nd,nd->n", x.astype(np.int64),
                      x.astype(np.int64)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    bits = t(np.full((npad, 1), -1, np.int32))
    args = (t(q), t(x), t(norms), bits, t(np.full((nq, 1), 1, np.int32)))
    before = _build.LAUNCHES["scan_int8_wide"]
    got = scan_int8.int8_group_minima_wide(*args, group=8, metric="l2")
    assert _build.LAUNCHES["scan_int8_wide"] == before + 1
    want = scan_int8.int8_group_minima_wide_plain(*args, group=8,
                                                  metric="l2")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("nq,npad,d_pad,w,group,metric,shift,sb,tile", [
    (16, 1024, 128, 4, 128, "l2", 0, 16, 0),
    (48, 1152, 128, 1, 8, "l2", 0, 16, 0),
    (96, 2048, 128, 8, 32, "ip", 0, 16, 32),
    (272, 1280, 256, 2, 64, "l2", 3, 8, 0),
    (320, 8192, 128, 4, 16, "l2", 0, 16, 64),
    (2048, 8192, 128, 4, 32, "l2", 0, 16, 2048),
    # mask_sb 8, 16 and 32 in both layouts (the contiguous layout with
    # mask_sb a multiple of 16 takes the warp-uniform admit path), d_pad
    # 256, shifts 3 and 9, W 1-8, rings that wrap
    (64, 1152, 128, 2, 8, "l2", 3, 8, 0),
    (256, 4736, 128, 5, 16, "ip", 9, 32, 0),
    (512, 25600, 256, 3, 128, "l2", 0, 32, 0),
    (96, 2048, 256, 6, 64, "l2", 3, 32, 96),
    (2048, 25600, 128, 7, 32, "l2", 0, 16, 0),
    (2048, 4736, 128, 1, 16, "ip", 3, 8, 512),
    (32, 128000, 128, 8, 8, "l2", 9, 16, 0),
])
def test_slot_form_bit_identical(dev, nq, npad, d_pad, w, group, metric,
                                 shift, sb, tile):
    """K1's slot form, contiguous (tile 0) and interleaved, against its
    plain version and against the per-query form on the expanded masks;
    slot 0 reads an empty mask, and sparse rows let whole warps skip."""
    q8, x8, norms, rb, qb = _scan_inputs(np.random.default_rng(nq + sb), dev,
                                         nq, npad, d_pad, w)
    slots = qb[:nq // sb].contiguous()
    kw = dict(group=group, metric=metric, score_shift=shift)
    before = dict(_build.LAUNCHES)
    got = scan_int8.int8_group_minima(q8, x8, norms, rb, slots,
                                      mask_sub_block=sb, slot_tile=tile, **kw)
    assert _build.LAUNCHES["scan_int8"] == before["scan_int8"] + 1
    assert _build.LAUNCHES["scan_int8_slots"] == before["scan_int8_slots"] + 1
    want = scan_int8.int8_group_minima_plain(
        q8, x8, norms, rb, slots, mask_sub_block=sb, slot_tile=tile, **kw)
    per_query = slots.index_select(0, scan_int8.slot_of_query(
        nq, sb, tile, dev)).contiguous()
    ctl = scan_int8.int8_group_minima(q8, x8, norms, rb, per_query, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, ctl)
    assert (got[:, 0] == scan_int8.MASKED_I32).all()


@pytest.mark.parametrize("sb,tile", [(16, 0), (8, 0), (32, 0), (16, 256),
                                     (8, 64), (32, 512)])
def test_slot_form_skips_what_no_slot_admits(dev, sb, tile):
    """Row tiles that a slot admits no row of, and tiles that no slot of a
    block (nor of the batch) admits: rows of tile t carry role t % 4, 10%
    of them outside role 0's tiles also role 5; slot s masks role s % 3 +
    1 and, one slot in five, role 5. Role 0's tiles are admitted by nobody, each slot misses
    two tiles of every four, and role 5 leaves mixed 8-row slices. The
    slot form and the per-query form on the expanded masks must equal
    the plain version."""
    rng = np.random.default_rng(sb + tile)
    nq, npad, d_pad, w = 512, 128 * 12, 128, 1
    x8 = rng.integers(-128, 128, size=(npad, d_pad)).astype(np.int8)
    q8 = rng.integers(-128, 128, size=(nq, d_pad)).astype(np.int8)
    norms = np.einsum("nd,nd->n", x8.astype(np.int64),
                      x8.astype(np.int64)).astype(np.int32)
    tile_role = np.arange(npad) // 128 % 4
    rbits = (1 << tile_role).astype(np.int32)
    rbits[(rng.random(npad) < 0.1) & (tile_role != 0)] |= 1 << 5
    slot = np.arange(nq // sb)
    sbits = (1 << (slot % 3 + 1)).astype(np.int32)
    sbits[slot % 5 == 0] |= 1 << 5
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    args = (t(q8), t(x8), t(norms), t(rbits[:, None]))
    slots = t(sbits[:, None])
    kw = dict(group=32, metric="l2", score_shift=0)
    before = _build.LAUNCHES["scan_int8_slots"]
    got = scan_int8.int8_group_minima(*args, slots, mask_sub_block=sb,
                                      slot_tile=tile, **kw)
    assert _build.LAUNCHES["scan_int8_slots"] == before + 1
    want = scan_int8.int8_group_minima_plain(*args, slots, mask_sub_block=sb,
                                             slot_tile=tile, **kw)
    per_query = slots.index_select(0, scan_int8.slot_of_query(
        nq, sb, tile, dev)).contiguous()
    ctl = scan_int8.int8_group_minima(*args, per_query, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(ctl, want)
    masked = scan_int8.MASKED_I32
    assert (got[0:4] == masked).all()          # tile 0: role 0, nobody
    assert (got[4:8] != masked).any()          # tile 1: some slots


# ---- K1's narrow forms: the group-128 close and the W <= 4 slot form

def _doc_world(rng, nq, npad, w, doc_rows=100, n_masks=60, n_rows=None):
    """A world where most row tiles hold no pair a block may read: rows in
    documents of doc_rows contiguous rows (pad rows past n_rows zero), one
    role each of 32 W; n_masks masks of one role each, the queries sorted
    by mask as admit-dedup sorts them. (bits (npad, W), masks (nq, W))."""
    roles = 32 * w
    n_rows = npad if n_rows is None else n_rows
    role = rng.integers(0, roles, -(-npad // doc_rows))[
        np.arange(n_rows) // doc_rows]
    bits = np.zeros((npad, w), np.uint32)
    bits[np.arange(n_rows), role // 32] = np.uint32(1) << (
        role % 32).astype(np.uint32)
    m_role = rng.integers(0, roles, n_masks)
    pool = np.zeros((n_masks, w), np.uint32)
    pool[np.arange(n_masks), m_role // 32] = np.uint32(1) << (
        m_role % 32).astype(np.uint32)
    masks = pool[np.sort(rng.integers(0, n_masks, nq))]
    return bits.view(np.int32), masks.view(np.int32)


def _narrow_case(dev, nq, npad, d_pad, w, group, metric, shift, sb, tile,
                 bits, masks):
    """K1 on (bits, masks) against its plain version, bit for bit; the slot
    forms also against the per-query form on the expanded masks."""
    rng = np.random.default_rng(nq + npad)
    x8 = rng.integers(-128, 128, size=(npad, d_pad)).astype(np.int8)
    q8 = rng.integers(-128, 128, size=(nq, d_pad)).astype(np.int8)
    norms = np.einsum("nd,nd->n", x8.astype(np.int64),
                      x8.astype(np.int64)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    args = (t(q8), t(x8), t(norms), t(bits))
    qbits = t(masks[::sb] if sb else masks)
    kw = dict(group=group, metric=metric, score_shift=shift)
    slot_kw = dict(mask_sub_block=sb, slot_tile=tile)
    got = scan_int8.int8_group_minima(*args, qbits, **kw, **slot_kw)
    want = scan_int8.int8_group_minima_plain(*args, qbits, **kw, **slot_kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if sb:
        per_query = qbits.index_select(0, scan_int8.slot_of_query(
            nq, sb, tile, dev)).contiguous()
        ctl = scan_int8.int8_group_minima(*args, per_query, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ctl)
    return got


@pytest.mark.parametrize("nq,npad,d_pad,w,group,metric,shift,sb,tile", [
    # the index's layout: contiguous slots of 16 (the warp-slot path), the
    # W <= 4 form and the W 5-8 form, group 128 and others
    (2048, 16384, 128, 4, 128, "l2", 0, 16, 0),
    (4096, 131072, 128, 1, 128, "l2", 0, 16, 0),    # 22 q-tiles
    (2048, 25600, 256, 3, 32, "ip", 3, 16, 0),
    (1008, 12800, 128, 8, 128, "ip", 9, 16, 0),
    # per-query masks: ragged query counts, every group, W 1-8, shifts
    (2047, 25600, 128, 2, 32, "l2", 3, 0, 0),
    (300, 4736, 256, 8, 8, "ip", 9, 0, 0),
    (1, 128000, 128, 3, 16, "ip", 9, 0, 0),
    (65, 12800, 128, 6, 64, "l2", 0, 0, 0),
    (777, 12800, 256, 4, 128, "l2", 3, 0, 0),
    # the other slot layouts (read through their mask rows)
    (512, 12800, 128, 5, 16, "l2", 0, 16, 256),
    (96, 4096, 256, 1, 64, "l2", 3, 8, 0),
    (2048, 25600, 128, 7, 128, "ip", 0, 32, 2048),
])
def test_narrow_forms_bit_identical(dev, nq, npad, d_pad, w, group, metric,
                                    shift, sb, tile):
    """K1's narrow forms on a sparse world (documents of contiguous rows,
    one role each; one-role masks sorted as admit-dedup sorts them), where
    most row tiles hold no pair a warpgroup may read and most of the rest
    admit only some slices: the output equals the plain version."""
    bits, masks = _doc_world(np.random.default_rng(npad + w), nq, npad, w,
                             n_masks=3 if w == 1 else 60)
    _narrow_case(dev, nq, npad, d_pad, w, group, metric, shift, sb, tile,
                 bits, masks)


@pytest.mark.parametrize("sb,group", [(0, 64), (16, 64), (0, 128),
                                      (16, 128)])
def test_q_tiles_that_admit_nothing_or_everything(dev, sb, group):
    """Three q-tiles: the first reads no role (every minimum masked), the
    second every role (every group of a row unmasked), the third a sparse
    mask; 100 pad rows at the end, and ragged ends of runs."""
    nq, npad, w = 576, 12800 + 256, 4
    bits, masks = _doc_world(np.random.default_rng(sb + group), nq, npad, w,
                             n_rows=npad - 100)
    masks = masks.copy()
    masks[:192] = 0
    masks[192:384] = -1
    got = _narrow_case(dev, nq, npad, 128, w, group, "l2", 0, sb, 0, bits,
                       masks)
    assert (got[:, :192] == scan_int8.MASKED_I32).all()
    full = (npad - 100) // group                 # groups with no pad row
    assert (got[:full, 192:384] != scan_int8.MASKED_I32).all()


@pytest.mark.parametrize("w", [9, 16, 32, 33, 64, 65, 128])
@pytest.mark.parametrize("form,sb,tile", [("per-query", 0, 0),
                                          ("slots-16", 16, 0),
                                          ("slots-8", 8, 0),
                                          ("interleaved", 16, 64)])
@pytest.mark.parametrize("d_pad,nq,npad,group,metric,shift", [
    (128, 320, 4736, 32, "l2", 0),      # K1, the index's geometry
    (256, 256, 2048, 8, "ip", 9),       # K1 at d_pad 256, a shift past 7
    (768, 128, 2048, 128, "l2", 3),     # K2
])
def test_wide_world_scans_bit_identical(dev, w, form, sb, tile, d_pad, nq,
                                        npad, group, metric, shift):
    """K1 (per-query and both slot layouts) and K2 (and its slot form) at W
    9, 16 and 32, the wide-world forms (binary tensor-core admit test),
    and 33, 64, 65 and 128, the huge forms (the same test 32 words at a
    time), against the plain version, bit for bit; the slot forms also
    against the per-query form on the expanded masks. Query (and slot) 0
    has no role, 1 every role, 2 only a role no row has, 3 only the other
    roles of the last word (admitted by the last word alone); one launch
    of the scan (and of its slot form) each."""
    q8, x8, norms, rb, qb = _scan_inputs(
        np.random.default_rng(w * d_pad + sb + tile), dev, nq, npad, d_pad,
        w)
    rb[:, w - 1] &= 0x7FFFFFFF                 # the last role: no row has it
    qb[1] = -1                                 # every role
    qb[2] = 0
    qb[2, w - 1] = -0x80000000                 # only the last role
    qb[3] = 0
    qb[3, w - 1] = 0x7FFFFFFF                  # the last word's others
    wide = d_pad > scan_int8.NARROW_MAX_D
    count = "scan_int8_wide" if wide else "scan_int8"
    kw = dict(group=group, metric=metric, score_shift=shift)
    bits = qb[:nq // sb].contiguous() if sb else qb
    slot_kw = dict(mask_sub_block=sb, slot_tile=tile) if sb else {}
    before = dict(_build.LAUNCHES)
    got = scan_int8.int8_group_minima(q8, x8, norms, rb, bits, **kw,
                                      **slot_kw)
    assert _build.LAUNCHES[count] == before[count] + 1
    assert _build.LAUNCHES[count + "_slots"] == before[count + "_slots"] + (
        1 if sb else 0)
    want = scan_int8.int8_group_minima_plain(q8, x8, norms, rb, bits, **kw,
                                             **slot_kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    slot = (scan_int8.slot_of_query(nq, sb, tile, dev) if sb
            else torch.arange(nq, device=dev))
    for s_empty in (0, 2):                     # no role, no shared role
        cols = (slot == s_empty).nonzero()[:, 0]
        assert (got[:, cols] == scan_int8.MASKED_I32).all()
    assert (got[:, (slot == 1).nonzero()[:, 0]] != scan_int8.MASKED_I32
            ).all()                             # every role: every group
    if sb:
        per_query = bits.index_select(0, slot).contiguous()
        ctl = scan_int8.int8_group_minima(q8, x8, norms, rb, per_query, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ctl)


def test_tiled_searcher_cuda_equals_cpu(dev):
    """A two-tier TiledSearcher (a 6000-row big tier, whose 1024 queries
    admit-dedup groups into slots, beside the chunk
    engine's partitions and the fan-out merge) on the card and on the
    CPU: identical distances and ids (lossless int8, exact float32 dots).
    1024 queries of four users, 256 each: whole slots, so the gate
    pads nothing."""
    from vectorsearch_rbac_tpu_torch import build_device_arena
    from vectorsearch_rbac_tpu_torch.bench import make_scenario
    from vectorsearch_rbac_tpu_torch.partition import TiledSearcher

    corpus, w, wl = make_scenario(n=16384, num_queries=1024, topk=10)
    rows = {0: np.arange(6000), 1: np.arange(6000, 9000),
            2: np.arange(9000, 13000)}
    users = np.random.default_rng(5).permutation(
        np.repeat([3, 300, 3000, 7000], 256))
    got = {}
    for d in (dev, torch.device("cpu")):
        arena = build_device_arena(corpus, w, device=d, block_rows=16384,
                                   dtype="int8")
        s = TiledSearcher(arena, rows, lambda uid: (0, 1) if uid % 2 else (0,
                          2), "mixed", big_chunks=2)
        assert list(s._big) == [0]
        before = dict(_build.LAUNCHES)
        got[d.type] = s.search_batch(wl.vectors, users, w.user_masks, 10)
        assert s._big[0]._last_dedup
        slot_launches = _build.LAUNCHES["scan_int8_slots"] - before[
            "scan_int8_slots"]
        assert slot_launches == (1 if d.type == "cuda" else 0)
    np.testing.assert_array_equal(got["cuda"][0], got["cpu"][0])
    np.testing.assert_array_equal(got["cuda"][1], got["cpu"][1])
    assert (got["cpu"][1] >= 0).mean() > 0.9


def test_qdtree_on_the_card(dev):
    """A QDTree over a 200,000-row SIFT-like corpus, built from its workload
    (the strategy compare's build), on the card and on the CPU: the same
    tree, identical distances and ids (lossless int8, exact float32 dots),
    and recall@10 against the exact float32 oracle on the card at least
    0.95."""
    from vectorsearch_rbac_tpu_torch import (GroundTruthOracle,
                                             build_device_arena,
                                             build_searcher)
    from vectorsearch_rbac_tpu_torch.bench import (compute_truth_sample,
                                                   make_scenario,
                                                   serving_config)
    from vectorsearch_rbac_tpu_torch.bench.ground_truth import (
        compute_recall)

    corpus, w, wl = make_scenario(n=200_000, num_queries=1024, topk=10)
    cfg = serving_config(seed=0, block_rows=16384, topk=10,
                         strategy="qdtree")
    got, leaves = {}, {}
    for d in (dev, torch.device("cpu")):
        arena = build_device_arena(corpus, w, device=d, block_rows=16384,
                                   dtype="int8")
        s = build_searcher("qdtree", corpus, w, arena, cfg, workload=wl,
                           min_leaf=64, max_depth=16)
        leaves[d.type] = [r.tolist() for r in s.tree.leaf_rows]
        got[d.type] = s.search_batch(wl.vectors, wl.user_ids, w.user_masks,
                                     10)
    assert leaves["cuda"] == leaves["cpu"] and len(leaves["cpu"]) > 1
    np.testing.assert_array_equal(got["cuda"][0], got["cpu"][0])
    np.testing.assert_array_equal(got["cuda"][1], got["cpu"][1])
    gt = build_device_arena(corpus, w, device=dev, block_rows=16384,
                            dtype="float32")
    truth = compute_truth_sample(GroundTruthOracle(gt, block_rows=16384),
                                 corpus, w, wl, 10, recall_sample=None)
    assert compute_recall(got["cuda"][1], truth) >= 0.95


def test_merge_kernels_at_the_rerank_width(dev):
    """K3 + K4 at kk = 100 + 32 (keep 136), the 768-d path's merge."""
    p = torch.from_numpy(_packed_with_ties(np.random.default_rng(132), 8192,
                                           200)).to(dev)
    assert merge.merge_supported(8192, 132)
    y, meta = merge.extract_pairs(p, 32, 16)
    ys, gs = merge.bitonic_pairs(y, meta, 136)
    ys_p, gs_p = merge.bitonic_pairs_plain(*merge.extract_pairs_plain(
        p, 32, 16), 136)
    torch.cuda.synchronize()
    assert torch.equal(ys, ys_p)
    cand = ys < scan_int8.EMPTY_I32
    assert torch.equal(gs[cand], gs_p[cand])
    vals, pos = merge.merge_topk(p, 132)
    assert vals.shape == pos.shape == (200, 132)


def _packed_with_ties(rng, ng, nq):
    p = rng.integers(1 << 10, (1 << 10) + 24, size=(ng, nq)).astype(np.int32)
    p = (p << 7) | rng.integers(0, 4, size=(ng, nq)).astype(np.int32)
    p[rng.random((ng, nq)) < 0.3] = scan_int8.MASKED_I32
    p[:, 1:2] = scan_int8.MASKED_I32            # a column with nothing
    return p


@pytest.mark.parametrize("ng,nq,nsub,t", [
    (2048, 300, 32, 16), (512, 40, 8, 8), (8192, 129, 32, 16),
    # the 10M arena's sub 2464, and sub 70, not a multiple of K3's team of
    # 8 lanes, at t 8, 16 and 32 and ragged query counts
    (2 * 2464, 1, 2, 8), (4 * 2464, 33, 4, 16), (2 * 2464, 129, 2, 32),
    (8 * 70, 129, 8, 8), (4 * 70, 1, 4, 16), (2 * 70, 33, 2, 32),
])
def test_extract_kernel_identical(dev, ng, nq, nsub, t):
    p = torch.from_numpy(_packed_with_ties(np.random.default_rng(ng), ng,
                                           nq)).to(dev)
    before = _build.LAUNCHES["merge_extract"]
    y, meta = merge.extract_pairs(p, nsub, t)
    assert _build.LAUNCHES["merge_extract"] == before + 1
    y_p, meta_p = merge.extract_pairs_plain(p, nsub, t)
    torch.cuda.synchronize()
    assert torch.equal(y, y_p)
    assert torch.equal(meta, meta_p)   # drained rounds included


@pytest.mark.parametrize("case", ["cross-lane-ties", "drained", "refill"])
def test_extract_kernel_lane_corners(dev, case):
    """K3 where its lanes meet: equal values in neighbouring rows (rows of
    different lanes) must extract once with the smallest meta; subgroups
    with fewer distinct values than t drain before round t; at t 64 a
    lane pops more than the 16 values it keeps and re-reads its rows."""
    rng = np.random.default_rng(len(case))
    nsub, sub, t, nq = {"cross-lane-ties": (4, 256, 16, 67),
                        "drained": (8, 64, 32, 40),
                        "refill": (2, 256, 64, 33)}[case]
    if case == "cross-lane-ties":      # runs of 8 equal rows: one a lane
        v = rng.integers(0, 1 << 20, size=(nsub * sub // 8, nq)) << 7
        p = np.repeat(v, 8, axis=0).astype(np.int32)
    elif case == "drained":            # 5 distinct values and the masked
        p = (rng.integers(100, 105, size=(nsub * sub, nq)) << 7).astype(
            np.int32)
        p[rng.random(p.shape) < 0.5] = scan_int8.MASKED_I32
        p[:, 3] = 2**31 - 1            # a column of the sentinel itself
    else:                              # every row distinct, ascending in
        p = (np.arange(nsub * sub)[:, None] * 1000 + rng.integers(      # lane 0
            0, 1000, size=(nsub * sub, nq))).astype(np.int32)
        p[::8] -= 1 << 24              # lane 0's rows hold the smallest 32
    p = torch.from_numpy(np.ascontiguousarray(p)).to(dev)
    before = _build.LAUNCHES["merge_extract"]
    y, meta = merge.extract_pairs(p, nsub, t)
    assert _build.LAUNCHES["merge_extract"] == before + 1
    y_p, meta_p = merge.extract_pairs_plain(p, nsub, t)
    torch.cuda.synchronize()
    assert torch.equal(y, y_p) and torch.equal(meta, meta_p)
    if case == "drained":
        assert (y_p.view(nsub, t, nq)[:, -1] == 2**31 - 1).all()


@pytest.mark.parametrize("npc,nq,keep", [
    (64, 33, 16), (512, 300, 104), (2048, 17, 2048),
    # the paths' npc 512 at keep 16 (top-10), 104 (top-100) and 136 (the
    # 768-d path's kk 132), at a full batch and ragged query counts
    (512, 2048, 16), (512, 2048, 104), (512, 2048, 136),
    (512, 1, 16), (512, 1, 104), (512, 1, 136),
    (512, 2049, 16), (512, 2049, 104), (512, 2049, 136),
    # the other instantiations: below a warp's 32 lanes, 32 and 1024 lanes'
    # worth, and npc 2048's two warps with the upper one stopping early
    (2, 5, 1), (8, 9, 8), (32, 40, 8), (1024, 20, 520), (2048, 33, 1024),
    (2048, 9, 104),
])
def test_bitonic_kernel_identical(dev, npc, nq, keep):
    """K4 against its plain version in every row, values and metas, on
    values in [0, 40) with random metas: ties everywhere, so a
    compare-exchange that orders equal values otherwise than the TPU
    network (a symmetric min/max across lanes) fails here."""
    rng = np.random.default_rng(npc)
    y = torch.from_numpy(rng.integers(0, 40, size=(npc, nq)).astype(
        np.int32)).to(dev)
    g = torch.from_numpy(rng.integers(0, 1 << 20, size=(npc, nq)).astype(
        np.int32)).to(dev)
    before = _build.LAUNCHES["merge_bitonic"]
    ys, gs = merge.bitonic_pairs(y, g, keep)
    assert _build.LAUNCHES["merge_bitonic"] == before + 1
    ys_p, gs_p = merge.bitonic_pairs_plain(y, g, keep)
    torch.cuda.synchronize()
    assert torch.equal(ys, ys_p) and torch.equal(gs, gs_p)
    assert (ys[1:] >= ys[:-1]).all()


@pytest.mark.parametrize("case", ["one-value", "from-extract"])
def test_bitonic_kernel_equal_values(dev, case):
    """K4 where only the tie rule orders the output: columns of one
    repeated value (INT32_MAX, the inadmissible 0x7F000000, a score) with
    distinct metas; and K3's output on drained and all-inadmissible
    columns, whose survivors repeat INT32_MAX and 0x7F000000 with
    different metas. Every row is compared, values and metas."""
    rng = np.random.default_rng(len(case))
    npc, nq, keep = 512, 70, 136
    if case == "one-value":
        y = np.empty((npc, nq), np.int32)
        y[:, 0::3] = 2**31 - 1
        y[:, 1::3] = scan_int8.MASKED_I32
        y[:, 2::3] = 1234 << 7
        g = rng.permutation(npc * nq).reshape(npc, nq).astype(np.int32)
        y, g = (torch.from_numpy(a).to(dev) for a in (y, g))
    else:
        p = _packed_with_ties(rng, 8192, nq)
        p[:, 2:6] = scan_int8.MASKED_I32        # all inadmissible
        p[5:, 6:9] = scan_int8.MASKED_I32       # drained after 5 groups
        p[:, 9] = 2**31 - 1                     # the sentinel itself
        y, g = merge.extract_pairs(torch.from_numpy(p).to(dev), 32, 16)
    before = _build.LAUNCHES["merge_bitonic"]
    ys, gs = merge.bitonic_pairs(y, g, keep)
    assert _build.LAUNCHES["merge_bitonic"] == before + 1
    ys_p, gs_p = merge.bitonic_pairs_plain(y, g, keep)
    torch.cuda.synchronize()
    assert torch.equal(ys, ys_p) and torch.equal(gs, gs_p)
    if case == "from-extract":
        assert (ys[:, 2:6] == scan_int8.MASKED_I32).any()
        assert (ys[:, 9] == 2**31 - 1).all()


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


def test_wide_search_cuda_equals_cpu(dev):
    """The 768-d cosine index (K2, merge, residual4 rerank, ids wire) on the
    card against the same index on the CPU (plain versions). The int8
    stages are bit-identical; the rerank's float32 sums run in another
    order, so the returned rows agree as sets except at near-ties."""
    from vectorsearch_rbac_tpu_torch import build_device_arena, build_searcher
    from vectorsearch_rbac_tpu_torch.bench import make_scenario, serving_config

    corpus, w, wl = make_scenario(n=16384, num_queries=300, topk=20,
                                  dataset="cohere")
    cfg = serving_config(block_rows=16384, batch=128, topk=20)
    got = {}
    for d in (dev, torch.device("cpu")):
        arena = build_device_arena(corpus, w, device=d, block_rows=16384,
                                   dtype="int8", metric="cosine")
        s = build_searcher("rls", corpus, w, arena, cfg)
        assert s.partitions[0].index.rerank_mode == "residual4"
        before = _build.LAUNCHES["scan_int8_wide"]
        _, got[d.type] = s.search_batch(wl.vectors, wl.user_ids,
                                        w.user_masks, 20)
        assert _build.LAUNCHES["scan_int8_wide"] == before + (
            3 if d.type == "cuda" else 0)
    same = [len(set(a) & set(b)) for a, b in zip(got["cuda"], got["cpu"])]
    assert np.mean(same) >= 19.9 and min(same) >= 18


def _misaligned(t):
    """A contiguous copy of t whose data starts one byte off 16."""
    raw = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.int8,
                      device=t.device)
    off = (1 - raw.data_ptr()) % 16
    out = raw[off:off + t.numel() * t.element_size()].view(t.dtype)
    return out.view(t.shape).copy_(t)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from vectorsearch_rbac_tpu_torch.ops import lab_scan

    q8, x8, *rest = _scan_inputs(np.random.default_rng(1), dev, 8, 1024, 128,
                                 33)
    with pytest.raises(ValueError, match="16-byte aligned"):
        scan_int8.int8_group_minima(q8, _misaligned(x8), *rest)
    q8, x8, *rest = _scan_inputs(np.random.default_rng(1), dev, 8, 1024, 384,
                                 33)
    with pytest.raises(ValueError, match="16-byte aligned"):
        scan_int8.int8_group_minima(_misaligned(q8), x8, *rest)  # K2
    args = _scan_inputs(np.random.default_rng(1), dev, 8, 1024, 128, 9)
    with pytest.raises(ValueError):             # the lab's forms: W <= 8
        lab_scan.lab_group_minima(*args, variant="chain")
    args = _scan_inputs(np.random.default_rng(1), dev, 8, 1000, 384, 1)
    with pytest.raises(ValueError):
        scan_int8.int8_group_minima(*args, group=8)   # npad % 128
    y = torch.zeros((4096, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        merge.bitonic_pairs(y, y, 8)


def _score_inputs(rng, dev, nq, c, npad, d, w, integer, multi):
    """Packed rows [int8 code | W bitset words | f32 norm] and queries: on
    integer data (SIFT-like) or on float data; ids with -1 pads, mapped
    through a (P, n_class) slab with per-query slots or a flat row map."""
    from vectorsearch_rbac_tpu_torch.ops import graph_step  # noqa: F401

    d_pad = -(-d // 128) * 128
    code = np.zeros((npad, d_pad), np.int8)
    code[:, :d] = rng.integers(-128, 128, (npad, d))
    bits = rng.integers(0, 2**32, (npad, w), dtype=np.uint64).astype(
        np.uint32)
    bits[rng.random((npad, w)) < 0.7] = 0
    if w > 32:
        bits[::2, :32] = 0      # rows admitted by the words past 32 alone
    norm = rng.random(npad).astype(np.float32) * 1e6
    packed = np.concatenate([code, bits.view(np.int8).reshape(npad, -1),
                             norm.view(np.int8).reshape(npad, 4)], axis=1)
    qf = np.zeros((nq, d_pad), np.float32)
    qf[:, :d] = (rng.integers(0, 256, (nq, d)) if integer
                 else rng.standard_normal((nq, d)) * 50)
    qmask = rng.integers(0, 2**32, (nq, w), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    qmask[::3, 32:] = 0         # and queries that do not have the rest
    qcd = rng.integers(-5000, 5000, nq).astype(np.float32)
    n_class = 512
    ids = rng.integers(-1, n_class, (nq, c)).astype(np.int32)
    ids[0] = -1                                  # a query with no candidate
    if multi:
        row_map = rng.integers(0, npad, (3, n_class)).astype(np.int32)
        pids = rng.integers(0, 3, nq).astype(np.int32)
    else:
        row_map = rng.integers(0, npad, n_class).astype(np.int32)
        pids = None
    t = lambda a: None if a is None else torch.from_numpy(
        np.ascontiguousarray(a)).to(dev)
    return (t(ids), t(packed), t(qf), t(qmask), t(qcd), 1.0 if integer
            else 0.37, t(row_map), t(pids))


@pytest.mark.parametrize("nq,c,d,w,integer,multi", [
    (1, 32, 128, 4, True, True),
    (300, 32, 128, 4, True, True),
    (77, 19, 128, 1, True, False),       # C not a power of two
    (64, 1024, 128, 4, True, True),      # the 2-hop harvest's M0^2
    (50, 32, 200, 8, True, False),       # d_pad 256
    (130, 32, 768, 2, False, True),      # float data: the tolerance
    # worlds of 1,024 roles and past: the role test loops past 32 words
    (300, 32, 128, 32, True, True),
    (77, 32, 128, 40, True, False),
    (64, 1024, 128, 64, True, True),
    (50, 32, 1100, 4, True, False),      # d_pad 1152: the floats from L1
    (30, 32, 1152, 40, False, True),
])
def test_graph_score_kernel_against_plain(dev, nq, c, d, w, integer, multi):
    """KS7: bit-identical on integer data; on float data within the
    stated tolerance, at 1-64 bitset words and d_pad 128-1152. -1 ids give
    +inf / False."""
    from vectorsearch_rbac_tpu_torch.ops import graph_step

    args = _score_inputs(np.random.default_rng(nq + c), dev, nq, c, 4096, d,
                         w, integer, multi)
    before = _build.LAUNCHES["graph_score"]
    s, ok = graph_step.graph_score_packed(*args)
    assert _build.LAUNCHES["graph_score"] == before + 1
    s_p, ok_p = graph_step.graph_score_packed_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ok, ok_p)
    assert torch.isinf(s[0]).all() and not ok[0].any()
    if integer:
        assert torch.equal(s, s_p)
    else:
        ids, packed, qf, qmask, qcd, dqs, row_map, pids = args
        rows = graph_step.candidate_rows(ids, row_map, pids).clamp_min(0)
        d_pad = qf.shape[1]
        absdot = torch.einsum("qd,qcd->qc", qf.abs(),
                              packed[rows.long(), :d_pad].float().abs())
        tol = (2 * dqs * (2 * d_pad * 2.0**-24) * absdot
               + 2.0**-20 * s_p.abs())
        fin = torch.isfinite(s_p)
        assert torch.equal(fin, torch.isfinite(s))
        assert ((s - s_p).abs()[fin] <= tol[fin]).all()


@pytest.mark.parametrize("w", [4, 10, 40])
@pytest.mark.parametrize("d", [128, 768])
@pytest.mark.parametrize("metric", ["ip", "cosine"])
def test_graph_score_kernel_ip_form_against_plain(dev, metric, d, w):
    """KS7's inner-product form (ip and cosine arenas: -dots) bit-identical
    to its plain version on integer data at 4, 10 and 40 bitset words and
    d_pad 128 and 768; -1 ids give +inf / False; the l2 form on the same
    inputs differs."""
    from vectorsearch_rbac_tpu_torch.ops import graph_step

    args = _score_inputs(np.random.default_rng(d + w), dev, 200, 32, 4096,
                         d, w, True, w != 10)
    before = _build.LAUNCHES["graph_score"]
    s, ok = graph_step.graph_score_packed(*args, metric=metric)
    assert _build.LAUNCHES["graph_score"] == before + 1
    s_p, ok_p = graph_step.graph_score_packed_plain(*args, metric=metric)
    s_l2, _ = graph_step.graph_score_packed(*args)
    torch.cuda.synchronize()
    assert torch.equal(ok, ok_p) and torch.equal(s, s_p)
    assert torch.isinf(s[0]).all() and not ok[0].any()
    fin = torch.isfinite(s)
    assert fin.any() and not torch.equal(s[fin], s_l2[fin])


@pytest.mark.parametrize("nq,ef,c,kk,cr,fill", [
    (1, 64, 32, 18, 32, "ties"),
    (4096, 64, 32, 18, 32, "ties"),
    (300, 64, 32, 18, 50, "ties"),       # the harvest width M0 + kk
    (77, 24, 13, 7, 20, "ties"),         # C not a power of two
    (130, 64, 32, 18, 32, "empty"),      # every candidate -1 / +inf
    (130, 64, 32, 18, 32, "equal"),      # every value equal: position order
])
def test_graph_merge_kernel_against_plain(dev, nq, ef, c, kk, cr, fill):
    """KS6: the three merges bit-identical to the plain stable sort, ids
    included, under ties, all-empty candidates and all-equal values."""
    from vectorsearch_rbac_tpu_torch.ops import graph_step

    rng = np.random.default_rng(nq + cr)

    def vals(w):
        if fill == "equal":
            return np.full((nq, w), 3.0, np.float32)
        v = rng.integers(0, 6, (nq, w)).astype(np.float32)
        v[rng.random((nq, w)) < 0.3] = np.inf
        return v

    ids = lambda w: rng.integers(-1, 1 << 16, (nq, w)).astype(np.int32)
    beam_d = np.sort(vals(ef), axis=1)
    beam_d[:, 0] = np.inf                        # the popped slot
    nd, nb, cand_d, cand_i = vals(c), ids(c), vals(cr), ids(cr)
    if fill == "empty":
        nd[:], nb[:], cand_d[:], cand_i[:] = np.inf, -1, np.inf, -1
    ins = [beam_d, ids(ef), nd, nb, np.sort(vals(ef), axis=1),
           np.sort(vals(kk), axis=1), ids(kk), cand_d, cand_i]
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in ins]
    before = _build.LAUNCHES["graph_merge"]
    got = graph_step.graph_merge_step(*t)
    assert _build.LAUNCHES["graph_merge"] == before + 1
    want = graph_step.graph_merge_step_plain(*t)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_graph_wrappers_refuse_a_device_mix(dev):
    from vectorsearch_rbac_tpu_torch.ops import graph_step

    args = list(_score_inputs(np.random.default_rng(3), dev, 8, 32, 1024,
                              128, 4, True, True))
    args[4] = args[4].cpu()
    with pytest.raises(ValueError, match="several devices"):
        graph_step.graph_score_packed(*args)
    z = torch.zeros((4, 8), device=dev)
    i = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="several devices"):
        graph_step.graph_merge_step(z, i, z, i, z, z, i, z.cpu(), i)
    with pytest.raises(ValueError):
        graph_step.graph_merge_step(z, i, z, i, z, z, i, z, i.long())


def test_hybrid_searcher_cuda_equals_cpu(dev):
    """Hybrid AnonySys at 20,000 rows on one plan, on the card and on the
    CPU: identical distances and ids (lossless int8, exact float32 dots,
    the graph kernels bit-identical to their plain versions); on the card
    the fused graph search and the flat scan launched. The device kNN
    builder gives the CPU's graph on the card too."""
    from vectorsearch_rbac_tpu_torch import build_device_arena, build_searcher
    from vectorsearch_rbac_tpu_torch.bench import make_scenario, serving_config
    from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex

    corpus, w, wl = make_scenario(n=20000, num_queries=512, topk=10)
    cfg = serving_config(block_rows=16384, topk=10, strategy="dynamic")
    cfg.optimizer.storage_alpha = 2.0
    plan = None
    got, graphs = {}, {}
    for d in (dev, torch.device("cpu")):
        arena = build_device_arena(corpus, w, device=d, block_rows=16384,
                                   dtype="int8")
        if plan is None:
            plan = build_searcher("dynamic", corpus, w, arena, cfg).plan
        cfg.index.kind = "hybrid"
        s = build_searcher("dynamic", corpus, w, arena, cfg, plan=plan,
                           packed=False)
        cfg.index.kind = "flat_approx"
        _build.reset_launches()
        got[d.type] = s.search_batch(wl.vectors, wl.user_ids, w.user_masks,
                                     10)
        if d.type == "cuda":
            fired = {k: v for k, v in _build.LAUNCHES.items() if v}
            assert {"graph_search", "scan_int8"} <= set(fired), fired
        graphs[d.type] = HNSWIndex(arena, np.arange(3000, 6000), m=8,
                                   builder="tpu").graph_state()
    np.testing.assert_array_equal(got["cuda"][0], got["cpu"][0])
    np.testing.assert_array_equal(got["cuda"][1], got["cpu"][1])
    assert (got["cpu"][1] >= 0).mean() > 0.9
    for key in ("neighbors", "entry"):
        np.testing.assert_array_equal(graphs["cuda"][key],
                                      graphs["cpu"][key])


# ---- the fused graph search: the whole iterative search in one launch

def _search_inputs(rng, dev, nq, m0, d_pad, w, mode, spread, n_class=1500,
                   npad=4096, budget_max=None):
    """Integer packed rows (codes in [-spread, spread], queries in [-20,
    20]: every dot and score an exact float32 integer, small spreads tie
    often), a random graph with -1 pads over n_class local nodes, and the
    per-query operands: a (3, n_class) slab with slots ("multi"), a 1-D row
    map ("logical") or none (ids are arena rows). Row map entries of -1
    (padded rows), entries that map to -1 or to a row no mask admits, and
    per-query step budgets (0 included) where budget_max is given."""
    d = d_pad - 7
    code = np.zeros((npad, d_pad), np.int8)
    code[:, :d] = rng.integers(-spread, spread + 1, (npad, d))
    bits = rng.integers(0, 2**32, (npad, w), dtype=np.uint64).astype(
        np.uint32)
    bits[rng.random((npad, w)) < 0.7] = 0
    if w > 32:
        bits[::2, :32] = 0      # rows admitted by the words past 32 alone
    bits[7] = 0                                  # a row no mask admits
    norm = (code.astype(np.float32) ** 2).sum(1, dtype=np.float32)
    packed = np.concatenate([code, bits.view(np.int8).reshape(npad, -1),
                             norm.view(np.int8).reshape(npad, 4)], axis=1)
    q = rng.integers(-20, 21, (nq, d)).astype(np.float32)
    qmask = rng.integers(0, 2**32, (nq, w), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    qmask[::3, 32:] = 0         # and queries that do not have the rest
    qcd = rng.integers(-5000, 5000, nq).astype(np.float32)
    n_nodes = npad if mode == "none" else n_class
    shape = ((3, n_class, m0) if mode == "multi" else (n_nodes, m0))
    graph = rng.integers(0, n_nodes, shape).astype(np.int32)
    graph[rng.random(shape) < 0.15] = -1         # graph row pads
    row_map = pids = None
    if mode == "multi":
        row_map = rng.integers(0, npad, (3, n_class)).astype(np.int32)
        pids = rng.integers(0, 3, nq).astype(np.int32)
    elif mode == "logical":
        row_map = rng.integers(0, npad, n_class).astype(np.int32)
    entries = rng.integers(0, n_nodes, nq).astype(np.int32)
    if row_map is not None:
        row_map[rng.random(row_map.shape) < 0.05] = -1
        row_map[..., 11] = -1                    # a padded entry
        row_map[..., 13] = 7                     # an inadmissible entry
        entries[:2] = (11, 13)
    else:
        entries[:2] = (-1, 7)
    sb = None
    if budget_max is not None:
        sb = rng.choice([0, 1, 5, budget_max // 2, budget_max], nq).astype(
            np.int32)
    t = lambda a: None if a is None else torch.from_numpy(
        np.ascontiguousarray(a)).to(dev)
    return dict(queries=t(q), graph=t(graph), query_masks=t(qmask),
                entries=t(entries), packed_rows=t(packed), dq_scale=1.0,
                q_center_dot=t(qcd), row_map=t(row_map), pids=t(pids),
                step_budget=t(sb))


@pytest.mark.parametrize(
    "nq,ef,kk,m0,max_steps,w,d_pad,mode,budget,spread", [
        (300, 64, 18, 32, 128, 4, 128, "multi", True, 20),   # hybrid cell
        (64, 16, 1, 8, 4096, 1, 128, "logical", False, 1),   # ties
        (50, 16, 16, 8, 1, 4, 256, "none", True, 20),        # kk = ef
        (40, 512, 512, 64, 4096, 8, 768, "multi", True, 20),
        (100, 64, 64, 64, 128, 8, 128, "logical", True, 1),  # M0 64, ties
        (33, 512, 10, 32, 128, 4, 256, "none", False, 20),
        (20, 1, 1, 8, 16, 1, 128, "multi", False, 20),       # done at entry
        (4096, 64, 18, 32, 128, 4, 128, "multi", True, 2),   # one wave
        # 1,024 roles and past: the role test loops past 32 words
        (300, 64, 18, 32, 128, 32, 128, "multi", True, 20),
        (100, 64, 18, 32, 128, 40, 256, "logical", True, 20),
        (64, 128, 10, 64, 256, 64, 768, "multi", True, 20),
    ])
def test_graph_search_fused_against_plain(dev, nq, ef, kk, m0, max_steps, w,
                                          d_pad, mode, budget, spread):
    """The fused search (through graph_beam_search_iterative, one launch,
    no step kernel) bit-equal in distances and ids to its plain loop, with
    the same expansions and scored candidates."""
    from vectorsearch_rbac_tpu_torch.ops import graph_search

    kw = _search_inputs(np.random.default_rng(nq + ef + m0), dev, nq, m0,
                        d_pad, w, mode, spread,
                        budget_max=max_steps if budget else None)
    args = (kw.pop("queries"), None, None, None, kw.pop("graph"),
            kw.pop("query_masks"), kw.pop("entries"), kk, ef, max_steps)
    before = dict(_build.LAUNCHES)
    got = graph_search.graph_beam_search_iterative(*args, **kw)
    after = dict(_build.LAUNCHES)
    assert after["graph_search"] == before["graph_search"] + 1
    assert after["graph_score"] == before["graph_score"]
    assert after["graph_merge"] == before["graph_merge"]
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    stats_p = torch.zeros_like(stats)
    graph_search.graph_search_fused(args[0], *args[4:], **kw, stats=stats)
    want = graph_search.graph_beam_search_iterative_plain(*args, **kw,
                                                          stats=stats_p)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    assert torch.equal(stats, stats_p), (stats, stats_p)
    assert (want[1][2:] >= 0).any()
    assert (want[1][0] < 0).all()                # the padded entry


@pytest.mark.parametrize("nq,ef,kk,m0,max_steps,w,d_pad,mode,metric", [
    (300, 64, 18, 32, 128, 4, 128, "multi", "ip"),       # hybrid cell
    (4096, 64, 18, 32, 128, 4, 128, "multi", "ip"),      # one wave
    (40, 512, 512, 64, 4096, 8, 768, "multi", "ip"),
    (100, 64, 18, 32, 128, 40, 256, "logical", "ip"),
    (64, 16, 1, 8, 4096, 1, 128, "none", "ip"),
    (300, 64, 18, 32, 128, 4, 768, "multi", "cosine"),   # unit queries
    (100, 64, 64, 64, 128, 40, 128, "logical", "cosine"),
])
def test_graph_search_fused_ip_form_against_plain(dev, nq, ef, kk, m0,
                                                  max_steps, w, d_pad, mode,
                                                  metric):
    """The fused search's inner-product form (through
    graph_beam_search_iterative, one launch, no step kernel) bit-equal in
    distances and ids to its plain loop, with the same expansions and
    scored candidates. Cosine's queries are unit vectors of four entries
    of +-0.5 (their normalisation is exact), so every score is exact and
    ties are frequent; the finish maps them to clip(1 + s, 0, 2)."""
    from vectorsearch_rbac_tpu_torch.ops import graph_search

    rng = np.random.default_rng(nq + ef + m0 + w)
    kw = _search_inputs(rng, dev, nq, m0, d_pad, w, mode, 3 if metric ==
                        "cosine" else 20, budget_max=max_steps)
    if metric == "cosine":
        q = np.zeros(tuple(kw["queries"].shape), np.float32)
        cols = np.argsort(rng.random(q.shape), axis=1)[:, :4]
        np.put_along_axis(q, cols, rng.choice([-0.5, 0.5], (nq, 4)), 1)
        kw["queries"] = torch.from_numpy(q).to(dev)
    args = (kw.pop("queries"), None, None, None, kw.pop("graph"),
            kw.pop("query_masks"), kw.pop("entries"), kk, ef, max_steps)
    before = dict(_build.LAUNCHES)
    got = graph_search.graph_beam_search_iterative(*args, metric=metric,
                                                   **kw)
    after = dict(_build.LAUNCHES)
    assert after["graph_search"] == before["graph_search"] + 1
    assert after["graph_score"] == before["graph_score"]
    assert after["graph_merge"] == before["graph_merge"]
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    stats_p = torch.zeros_like(stats)
    graph_search.graph_search_fused(args[0], *args[4:], **kw, stats=stats,
                                    metric=metric)
    want = graph_search.graph_beam_search_iterative_plain(
        *args, metric=metric, **kw, stats=stats_p)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    assert torch.equal(stats, stats_p), (stats, stats_p)
    assert (want[1][2:] >= 0).any()
    assert (want[1][0] < 0).all()                # the padded entry


def test_graph_search_fused_refuses_other_shapes(dev):
    """Outside the kernel's shapes the fused search raises before any
    launch; it never falls back to the step loop (the shapes' dispatch
    to the step loop is graph_beam_search_iterative's, tested below)."""
    from vectorsearch_rbac_tpu_torch.ops import graph_search

    kw = _search_inputs(np.random.default_rng(5), dev, 8, 32, 128, 4,
                        "multi", 20)
    q, g, m, e = (kw.pop(k) for k in ("queries", "graph", "query_masks",
                                      "entries"))
    before = dict(_build.LAUNCHES)
    for bad in (dict(ef=1024, k=10), dict(ef=64, k=80),
                dict(ef=64, k=10, max_steps=5000),
                dict(ef=64, k=10, graph=torch.zeros((3, 1500, 128),
                                                    dtype=torch.int32,
                                                    device=dev)),
                dict(ef=64, k=10, graph=g.long())):
        call = {**dict(ef=64, k=10, max_steps=64, graph=g), **bad}
        with pytest.raises(ValueError, match="graph_search_fused"):
            graph_search.graph_search_fused(
                q, call["graph"], m, e, call["k"], call["ef"],
                call["max_steps"], **kw)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("nq,ef,kk,m0,max_steps,mode", [
    (64, 1024, 10, 32, 4096, "multi"),      # ef past 512, 4 ef steps
    (100, 64, 18, 96, 128, "multi"),        # M0 96: hnsw_m 48
    (40, 64, 10, 16, 8192, "logical"),      # a step budget past 4096
])
def test_hybrid_search_outside_the_fused_shapes(dev, nq, ef, kk, m0,
                                                max_steps, mode):
    """Shapes the fused kernel does not take go to the step loop on the
    card: KS7 and KS6 launch, the fused search does not, and the results
    equal the plain loop's, distances and ids."""
    from vectorsearch_rbac_tpu_torch.ops import graph_search

    kw = _search_inputs(np.random.default_rng(nq + ef + m0), dev, nq, m0,
                        128, 4, mode, 20, budget_max=min(max_steps, 2048))
    args = (kw.pop("queries"), None, None, None, kw.pop("graph"),
            kw.pop("query_masks"), kw.pop("entries"), kk, ef, max_steps)
    assert graph_search.fused_shape_problems(4, 128, 121, m0, kk, ef,
                                             max_steps)
    before = dict(_build.LAUNCHES)
    got = graph_search.graph_beam_search_iterative(*args, **kw)
    after = dict(_build.LAUNCHES)
    want = graph_search.graph_beam_search_iterative_plain(*args, **kw)
    torch.cuda.synchronize()
    assert after["graph_search"] == before["graph_search"]
    assert after["graph_score"] > before["graph_score"]
    assert after["graph_merge"] > before["graph_merge"]
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert (want[1][2:] >= 0).any()


@pytest.mark.parametrize("w,harvest", [(4, False), (40, False), (40, True)])
def test_graph_search_past_d_pad_1024(dev, w, harvest):
    """Packed rows of d_pad 1152 (past the fused kernel's d_pads and KS7's
    register form) run the step loop on the card, KS7 reading the query's
    floats from L1, with and without the harvest, at 4 and 40 bitset
    words: KS7 and KS6 launch, the fused search does not, and the results
    equal the plain loop's, distances and ids."""
    from vectorsearch_rbac_tpu_torch.ops import graph_search

    kw = _search_inputs(np.random.default_rng(w + harvest), dev, 48, 16,
                        1152, w, "logical", 20, budget_max=32)
    args = (kw.pop("queries"), None, None, None, kw.pop("graph"),
            kw.pop("query_masks"), kw.pop("entries"), 10, 32, 32, harvest)
    before = dict(_build.LAUNCHES)
    got = graph_search.graph_beam_search_iterative(*args, **kw)
    after = dict(_build.LAUNCHES)
    want = graph_search.graph_beam_search_iterative_plain(*args, **kw)
    torch.cuda.synchronize()
    assert after["graph_search"] == before["graph_search"]
    assert after["graph_score"] > before["graph_score"]
    assert after["graph_merge"] > before["graph_merge"]
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert (want[1][2:] >= 0).any()


@pytest.mark.parametrize("packed", [True, False], ids=["harvest", "unpacked"])
def test_graph_step_loop_keeps_the_step_kernels(dev, packed):
    """The 2-hop harvest (packed) and the unpacked scorer keep the step
    loop: KS6 (and KS7 where packed) launch, the fused search does not,
    and the outputs equal the plain loop's."""
    from vectorsearch_rbac_tpu_torch.ops import graph_search

    kw = _search_inputs(np.random.default_rng(9), dev, 64, 16, 128, 4,
                        "logical", 20, budget_max=32)
    args = (kw.pop("queries"), None, None, None, kw.pop("graph"),
            kw.pop("query_masks"), kw.pop("entries"), 10, 32, 32, packed)
    if not packed:
        rows = kw["packed_rows"]
        d = args[0].shape[1]
        args = (args[0], rows[:, :d].float(), rows[:, -4:].contiguous()
                .view(torch.float32)[:, 0], rows[:, 128:-4].contiguous()
                .view(torch.int32), *args[4:10], False)
        for key in ("packed_rows", "dq_scale", "q_center_dot"):
            kw.pop(key)
    before = dict(_build.LAUNCHES)
    got = graph_search.graph_beam_search_iterative(*args, **kw)
    after = dict(_build.LAUNCHES)
    want = graph_search.graph_beam_search_iterative_plain(*args, **kw)
    torch.cuda.synchronize()
    assert after["graph_search"] == before["graph_search"]
    assert after["graph_merge"] > before["graph_merge"]
    assert (after["graph_score"] > before["graph_score"]) == packed
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


# ---- online maintenance: a grown, refined and repaired graph, and a
# tombstoned arena

@pytest.fixture(scope="module")
def maintained(dev):
    """A logical HNSWIndex over rows [0, 2500) of a 20,000-row SIFT-like
    int8 arena, on the card and on the CPU, each through insert_rows of rows
    [2500, 5000) (the graph grows from 4,096 to 8,192 nodes), refine_rows
    of them and delete_rows of 300 rows after tombstone_rows."""
    from vectorsearch_rbac_tpu_torch import build_device_arena
    from vectorsearch_rbac_tpu_torch.bench import make_scenario
    from vectorsearch_rbac_tpu_torch.core import tombstone_rows
    from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex

    corpus, w, wl = make_scenario(n=20000, num_queries=700, topk=10)
    dels = np.random.default_rng(1).choice(5000, 300, replace=False)
    out = {}
    for d in (dev, torch.device("cpu")):
        arena = build_device_arena(corpus, w, device=d, block_rows=2048,
                                   dtype="int8")
        ix = HNSWIndex(arena, np.arange(2500), m=8, ef_search=64,
                       query_batch=4096, builder="classic", seed=0,
                       logical=True)
        ix.insert_rows(arena, np.arange(2500, 5000))
        ix.refine_rows(arena, np.arange(2500, 5000))
        arena2 = tombstone_rows(arena, dels)
        assert ix.delete_rows(arena2, dels) == 300
        out[d.type] = (ix, arena2)
    return out, dels, w, wl


def test_maintained_graph_on_the_card_equals_the_cpu(maintained):
    """Insert, refine and delete give the same graph, row map, entry and
    deleted nodes on the card as on the CPU (the candidate searches score
    exact integer dots on both), and the card's device graph and row map
    equal its host mirrors after the delta scatters."""
    out, dels, _, _ = maintained
    (gpu, _), (cpu, _) = out["cuda"], out["cpu"]
    assert gpu._hgraph.shape == (8192, 16) and gpu.n_rows == 5000
    for key in ("_hgraph", "_hrmap", "_deleted_local"):
        np.testing.assert_array_equal(getattr(gpu, key), getattr(cpu, key))
    assert gpu.entry == cpu.entry
    np.testing.assert_array_equal(gpu._graph.cpu().numpy(), gpu._hgraph)
    np.testing.assert_array_equal(gpu._row_map.cpu().numpy(), gpu._hrmap)


def test_fused_search_on_a_maintained_graph(maintained):
    """The sampled-entry search of the grown, refined and repaired graph
    (padded nodes past 5,000, -1 row-map entries of the 300 deleted nodes,
    -1 graph pads) through the fused kernel: its first chunk bit-equal to
    the plain loop in distances, ids and counts, the pass equal to the
    CPU's, no deleted row returned."""
    from vectorsearch_rbac_tpu_torch.index import hnsw as hnsw_mod
    from vectorsearch_rbac_tpu_torch.ops import graph_search

    out, dels, w, wl = maintained
    (gpu, _), (cpu, _) = out["cuda"], out["cpu"]
    rm = gpu._hrmap
    assert (rm[np.flatnonzero(gpu._deleted_local)] == -1).all()
    assert (rm[gpu.n_rows:] == -1).all() and (gpu._hgraph < 0).any()
    masks = w.user_masks[wl.user_ids]
    calls = []
    real = hnsw_mod.graph_beam_search_iterative

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    hnsw_mod.graph_beam_search_iterative = record
    try:
        before = _build.LAUNCHES["graph_search"]
        got = gpu.search(wl.vectors, masks, 10, sampled_entry=True)
        assert _build.LAUNCHES["graph_search"] > before
    finally:
        hnsw_mod.graph_beam_search_iterative = real
    want = cpu.search(wl.vectors, masks, 10, sampled_entry=True)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert not np.isin(got[1], dels).any() and (got[1] >= 0).mean() > 0.5
    args, kw = calls[0]
    assert kw["packed_rows"] is not None and kw["row_map"] is gpu._row_map
    stats = torch.zeros(2, dtype=torch.int64, device=args[0].device)
    stats_p = torch.zeros_like(stats)
    fused = graph_search.graph_search_fused(
        args[0], *args[4:10], kw["packed_rows"], stats=stats,
        dq_scale=kw["dq_scale"], q_center_dot=kw["q_center_dot"],
        row_map=kw["row_map"], metric=kw["metric"])
    plain = graph_search.graph_beam_search_iterative_plain(
        *args[:10], **kw, stats=stats_p)
    torch.cuda.synchronize()
    assert torch.equal(fused[1], plain[1]) and torch.equal(fused[0],
                                                           plain[0])
    assert torch.equal(stats, stats_p) and int(stats[0]) > 0


def test_fused_search_on_a_physical_partition(dev):
    """A physical HNSW partition (logical=False, the default) on the card
    serves its sampled-entry search from its own packed table with a null
    row map: the fused kernel launches on that table, its first chunk
    bit-equal to the plain loop in distances, ids and counts; the pass
    equals the CPU's and the logical twin's (made from its graph_state
    and served through the arena's packed rows and the row map)."""
    from vectorsearch_rbac_tpu_torch import build_device_arena
    from vectorsearch_rbac_tpu_torch.bench import make_scenario
    from vectorsearch_rbac_tpu_torch.index import hnsw as hnsw_mod
    from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex
    from vectorsearch_rbac_tpu_torch.ops import graph_search

    corpus, w, wl = make_scenario(n=20000, num_queries=700, topk=10)
    rows = np.arange(3000, 9000)
    masks = w.user_masks[wl.user_ids]
    got = {}
    for d in (dev, torch.device("cpu")):
        arena = build_device_arena(corpus, w, device=d, block_rows=2048,
                                   dtype="int8")
        ix = HNSWIndex(arena, rows, m=8, ef_search=64, query_batch=4096,
                       builder="classic", seed=0)
        assert not ix.logical and ix._table is not None
        assert ix._table.shape == (8192, arena.quant.d_pad
                                   + 4 * arena.role_bits.shape[1] + 4)
        if d.type == "cuda":
            calls = []
            real = hnsw_mod.graph_beam_search_iterative

            def record(*args, **kw):
                calls.append((args, kw))
                return real(*args, **kw)

            hnsw_mod.graph_beam_search_iterative = record
            try:
                before = _build.LAUNCHES["graph_search"]
                got[d.type] = ix.search(wl.vectors, masks, 10,
                                        sampled_entry=True)
                assert _build.LAUNCHES["graph_search"] > before
            finally:
                hnsw_mod.graph_beam_search_iterative = real
            twin = HNSWIndex(arena, rows, m=8, ef_search=64,
                             query_batch=4096, graph_state=ix.graph_state(),
                             logical=True)
            got["twin"] = twin.search(wl.vectors, masks, 10,
                                      sampled_entry=True)
        else:
            got[d.type] = ix.search(wl.vectors, masks, 10,
                                    sampled_entry=True)
    for other in ("cpu", "twin"):
        np.testing.assert_array_equal(got["cuda"][1], got[other][1])
        np.testing.assert_array_equal(got["cuda"][0], got[other][0])
    assert (got["cuda"][1] >= 0).mean() > 0.5
    args, kw = calls[0]
    assert kw["row_map"] is None and kw["packed_rows"].shape[0] == 8192
    stats = torch.zeros(2, dtype=torch.int64, device=args[0].device)
    stats_p = torch.zeros_like(stats)
    fused = graph_search.graph_search_fused(
        args[0], *args[4:10], kw["packed_rows"], stats=stats,
        dq_scale=kw["dq_scale"], q_center_dot=kw["q_center_dot"],
        row_map=None, metric=kw["metric"])
    plain = graph_search.graph_beam_search_iterative_plain(
        *args[:10], **kw, stats=stats_p)
    torch.cuda.synchronize()
    assert torch.equal(fused[1], plain[1]) and torch.equal(fused[0],
                                                           plain[0])
    assert torch.equal(stats, stats_p) and int(stats[0]) > 0


def test_scan_kernel_on_a_tombstoned_arena(maintained):
    """K1 over a tombstoned arena's bitsets (10% of the rows zeroed in
    place of a rebuild) bit-identical to its plain version, and an rls
    Int8FlatIndex over that arena returns no tombstoned row, equal to the
    CPU's."""
    from vectorsearch_rbac_tpu_torch.core import tombstone_rows
    from vectorsearch_rbac_tpu_torch.index.flat_int8 import Int8FlatIndex

    out, _, w, wl = maintained
    gone = np.random.default_rng(3).choice(20000, 2000, replace=False)
    res = {}
    for name in ("cuda", "cpu"):
        arena = tombstone_rows(out[name][1], gone)
        ix = Int8FlatIndex(arena, None, query_batch=512, block_rows=2048,
                           wire="f32")
        res[name] = ix.search(wl.vectors, w.user_masks[wl.user_ids], 10)
        if name == "cuda":
            q = arena.quant
            q8, _ = q.quantize_queries(wl.vectors, with_norms=False)
            qbits = np.ascontiguousarray(
                w.user_masks[wl.user_ids]).view(np.int32)
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
                arena.device)
            scan = (t(q8), q.vectors_q, q.norms_q, arena.role_bits,
                    t(qbits))
            kw = dict(group=ix.group, metric="l2",
                      score_shift=q.score_shift)
            before = _build.LAUNCHES["scan_int8"]
            got = scan_int8.int8_group_minima(*scan, **kw)
            assert _build.LAUNCHES["scan_int8"] == before + 1
            want = scan_int8.int8_group_minima_plain(*scan, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
    for a, b in zip(res["cuda"], res["cpu"]):
        np.testing.assert_array_equal(a, b)
    assert not np.isin(res["cuda"][1], gone).any()
    assert (res["cuda"][1] >= 0).mean() > 0.5


# ---- the kernel lab's kernels: K1's trim and floor epilogues (S1) and
# trim's control (the chain), K2's slot form, the y-form extraction (S4) and
# bitonic sort (S5)

@pytest.mark.parametrize("variant", ["dp4a", "trim", "floor", "chain"])
@pytest.mark.parametrize("nq,npad,d_pad,w,group,metric,shift", [
    (1, 1024, 128, 4, 128, "l2", 0),
    (37, 1152, 128, 1, 8, "ip", 0),
    (257, 1280, 256, 8, 64, "l2", 3),
    (2048, 8192, 128, 4, 128, "l2", 0),
    (65, 4736, 256, 3, 32, "ip", 9),
])
def test_lab_scan_variants_bit_identical(dev, variant, nq, npad, d_pad, w,
                                         group, metric, shift):
    """Each lab variant against its plain version; all but the floor's
    minima are also K1's."""
    from vectorsearch_rbac_tpu_torch.ops import lab_scan

    args = _scan_inputs(np.random.default_rng(nq + 7), dev, nq, npad, d_pad,
                        w)
    kw = dict(group=group, metric=metric, score_shift=shift)
    before = dict(_build.LAUNCHES)
    got = lab_scan.lab_group_minima(*args, variant=variant, **kw)
    name = f"scan_int8_{variant}"
    assert _build.LAUNCHES[name] == before[name] + 1
    assert _build.LAUNCHES["scan_int8"] == before["scan_int8"]
    want = lab_scan.lab_group_minima(*(a.cpu() for a in args),
                                     variant=variant, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if variant != "floor":
        assert torch.equal(got, scan_int8.int8_group_minima(*args, **kw))


@pytest.mark.parametrize("variant", ["trim", "chain"])
@pytest.mark.parametrize("nq,npad,d_pad,w,group,metric,shift", [
    (37, 1152, 128, 1, 8, "l2", 0),
    (100, 2048, 128, 4, 128, "ip", 3),
    (257, 1280, 256, 5, 64, "l2", 9),
    (130, 4736, 256, 8, 32, "ip", 0),
    (65, 2048, 128, 5, 16, "ip", 9),
    (199, 1152, 256, 4, 128, "l2", 3),
    (1, 1024, 256, 1, 8, "ip", 3),
    (385, 2048, 128, 8, 64, "l2", 0),
])
def test_trim_and_chain_against_k1_plain(dev, variant, nq, npad, d_pad, w,
                                         group, metric, shift):
    """S1 trim (K1's per-query form) and its control, the reference's
    literal chain, against K1's plain version at d_pad 128 and 256, W 1-8
    (both word forms), l2 and ip, shifts 0, 3 and 9 (past 7), query counts
    that fill no 64- or 192-query tile; one launch of its own counter."""
    from vectorsearch_rbac_tpu_torch.ops import lab_scan

    args = _scan_inputs(np.random.default_rng(nq + w + shift), dev, nq,
                        npad, d_pad, w)
    kw = dict(group=group, metric=metric, score_shift=shift)
    before = dict(_build.LAUNCHES)
    got = lab_scan.lab_group_minima(*args, variant=variant, **kw)
    fired = {k for k, v in _build.LAUNCHES.items() if v != before[k]}
    assert fired == {f"scan_int8_{variant}"}
    assert _build.LAUNCHES[f"scan_int8_{variant}"] == (
        before[f"scan_int8_{variant}"] + 1)
    want = scan_int8.int8_group_minima_plain(*(a.cpu() for a in args), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("shift", [0, 9])
@pytest.mark.parametrize("d_pad,group", [(128, 8), (256, 32)])
def test_chain_extreme_operands(dev, d_pad, group, shift):
    """The chain and trim with every product at its extreme (-128 * -128
    and -128 * 127), l2, where the scores come closest to the int32 range
    and the most negative ones keep their sign through the shift."""
    from vectorsearch_rbac_tpu_torch.ops import lab_scan

    nq, npad = 70, 512
    x = np.full((npad, d_pad), -128, np.int8)
    x[1::2] = 127
    q = np.full((nq, d_pad), -128, np.int8)
    q[::3, ::2] = 127
    norms = np.einsum("nd,nd->n", x.astype(np.int64),
                      x.astype(np.int64)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    args = (t(q), t(x), t(norms), t(np.full((npad, 1), -1, np.int32)),
            t(np.full((nq, 1), 1, np.int32)))
    kw = dict(group=group, metric="l2", score_shift=shift)
    want = scan_int8.int8_group_minima_plain(*args, **kw)
    for variant in ("chain", "trim"):
        got = lab_scan.lab_group_minima(*args, variant=variant, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), variant


@pytest.mark.parametrize("d_pad,w,group", [(256, 8, 32), (128, 4, 128)])
def test_floor_extreme_operands(dev, d_pad, w, group):
    """The floor on K1's tensor-core schedule at its range's ends: every
    dot at +-127^2 * d_pad (a group's rows and each query all +127 or all
    -127) and every role word set on both sides (the count at 32 W, 256 at
    W 8), beside groups and queries that share no role (count 0). dots and
    count add as plain int32, as in the plain version."""
    from vectorsearch_rbac_tpu_torch.ops import lab_scan

    nq, npad = 130, 1024
    g_of_row = np.arange(npad) // group
    sign_x = np.where(g_of_row % 2 == 0, 1, -1)
    sign_q = np.where(np.arange(nq) % 2 == 0, 1, -1)
    x8 = np.repeat(127 * sign_x[:, None], d_pad, axis=1).astype(np.int8)
    q8 = np.repeat(127 * sign_q[:, None], d_pad, axis=1).astype(np.int8)
    norms = np.full(npad, 127 * 127 * d_pad, np.int32)
    rbits = np.full((npad, w), -1, np.int32)
    qbits = np.full((nq, w), -1, np.int32)
    rbits[g_of_row % 4 == 3] = 0               # groups that share no role
    qbits[np.arange(nq) % 5 == 4] = 0          # queries that share none
    top = 127 * 127 * d_pad
    n_groups = npad // group
    share = ((np.arange(n_groups) % 4 != 3)[:, None]
             & (np.arange(nq) % 5 != 4)[None, :])
    expect = (np.where(np.arange(n_groups) % 2 == 0, 1, -1)[:, None]
              * sign_q[None, :] * top + 32 * w * share).astype(np.int32)
    assert {top + 32 * w, -top, -top + 32 * w, top} <= set(expect.ravel())
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    args = tuple(t(a) for a in (q8, x8, norms, rbits, qbits))
    before = dict(_build.LAUNCHES)
    got = lab_scan.lab_group_minima(*args, group=group, variant="floor")
    fired = {k for k, v in _build.LAUNCHES.items() if v != before[k]}
    assert fired == {"scan_int8_floor"}
    want = lab_scan.floor_minima_plain(*args, group)
    torch.cuda.synchronize()
    assert torch.equal(want.cpu(), torch.from_numpy(expect))
    assert torch.equal(got, want)


@pytest.mark.parametrize("nq,npad,d_pad,w,group,metric,shift,sb,tile", [
    (16, 1024, 384, 4, 128, "l2", 2, 16, 0),
    (48, 1152, 384, 1, 8, "ip", 0, 16, 48),
    (96, 2048, 768, 8, 32, "ip", 3, 16, 32),
    (320, 1280, 512, 2, 64, "l2", 1, 8, 0),
    (2048, 8192, 768, 4, 128, "ip", 3, 16, 512),
    (64, 1024, 384, 7, 128, "l2", 2, 16, 0),
    (160, 1280, 640, 4, 16, "ip", 0, 16, 32),
    (2048, 2048, 512, 8, 32, "l2", 1, 16, 512),
    (48, 1152, 768, 1, 64, "ip", 3, 8, 48),
])
def test_wide_slot_form_bit_identical(dev, nq, npad, d_pad, w, group, metric,
                                      shift, sb, tile):
    """K2's slot form, contiguous (tile 0) and interleaved, against its
    plain version and against the per-query form on the expanded masks;
    slot 0 reads an empty mask."""
    q8, x8, norms, rb, qb = _scan_inputs(np.random.default_rng(nq + sb), dev,
                                         nq, npad, d_pad, w)
    slots = qb[:nq // sb].contiguous()
    kw = dict(group=group, metric=metric, score_shift=shift)
    before = dict(_build.LAUNCHES)
    got = scan_int8.int8_group_minima(q8, x8, norms, rb, slots,
                                      mask_sub_block=sb, slot_tile=tile, **kw)
    assert (_build.LAUNCHES["scan_int8_wide_slots"]
            == before["scan_int8_wide_slots"] + 1)
    want = scan_int8.int8_group_minima_wide_plain(
        q8, x8, norms, rb, slots, mask_sub_block=sb, slot_tile=tile, **kw)
    per_query = slots.index_select(0, scan_int8.slot_of_query(
        nq, sb, tile, dev)).contiguous()
    ctl = scan_int8.int8_group_minima(q8, x8, norms, rb, per_query, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, ctl)
    assert (got[:, 0] == scan_int8.MASKED_I32).all()


@pytest.mark.parametrize("ng,nq,sub,t", [(2048, 300, 128, 16),
                                         (512, 40, 64, 8),
                                         (8192, 129, 128, 8),
                                         (256, 33, 8, 16)])
def test_y_extract_kernel_identical(dev, ng, nq, sub, t):
    """S4 against its plain version, on minima with ties, inadmissible
    groups and an empty column (drained subgroups, and t > sub)."""
    from vectorsearch_rbac_tpu_torch.ops import lab_merge

    p = torch.from_numpy(_packed_with_ties(np.random.default_rng(ng + t), ng,
                                           nq)).to(dev)
    before = _build.LAUNCHES["merge_y_extract"]
    y = lab_merge.subgroup_extract(p, sub, t)
    assert _build.LAUNCHES["merge_y_extract"] == before + 1
    y_p = lab_merge.subgroup_extract_plain(p, sub, t)
    torch.cuda.synchronize()
    assert torch.equal(y, y_p)


@pytest.mark.parametrize("t", [1, 8, 16, 32, 48])
@pytest.mark.parametrize("sub", [8, 32, 128])
def test_y_extract_kernel_lists(dev, sub, t):
    """S4's kernel at every list it is templated on (t <= 8, 16, 32) and
    past the largest (t 48: a second read of the column), at t 1, against
    its plain version: drained subgroups (t > sub), a subgroup whose
    groups are all inadmissible (positions in order), a column with
    nothing, negative and extreme minima, 45 queries (not a multiple of a
    warp); one launch of its counter."""
    from vectorsearch_rbac_tpu_torch.ops import lab_merge

    ng, nq = 4 * 128, 45
    rng = np.random.default_rng(sub * 100 + t)
    p = _packed_with_ties(rng, ng, nq)
    neg = rng.random((ng, nq)) < 0.1               # negative scores
    p[neg] = rng.integers(-(1 << 31), 0, size=int(neg.sum()),
                          dtype=np.int64).astype(np.int32)
    p[sub:2 * sub] = scan_int8.MASKED_I32          # subgroup 1: inadmissible
    p[0, 2], p[sub - 1, 3] = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    p = torch.from_numpy(p).to(dev)
    before = dict(_build.LAUNCHES)
    y = lab_merge.y_extract(p, sub, t)
    fired = {k for k, v in _build.LAUNCHES.items() if v != before[k]}
    assert fired == {"merge_y_extract"}
    y_p = lab_merge.y_extract_plain(p.cpu(), sub, t)
    torch.cuda.synchronize()
    assert torch.equal(y.cpu(), y_p)
    rows = y_p.view(ng // sub, t, nq)
    assert (rows[1, :min(t, sub)] == (scan_int8.MASKED_I32 | torch.arange(
        min(t, sub), dtype=torch.int32)[:, None])).all()
    if t > sub:
        assert (rows[:, sub:] == np.iinfo(np.int32).max).all()


# S5 at every npc its network is instantiated for, keep 1, 104 (or npc
# below it) and npc, with query counts 1, 7 and 2049 (no block of 8 full;
# more than a batch), t 1, 8 and 16 and sub 1, 100 and 128 in turn
_S5_GRID = [(npc, keep) for npc in (2, 4, 8, 16, 32, 64, 128, 256, 512,
                                    1024, 2048)
            for keep in sorted({1, min(104, npc), npc})]
_S5_CASES = [(64, 33, 16, 8, 128), (512, 300, 104, 8, 128),
             (1024, 129, 128, 16, 64), (2048, 17, 2048, 16, 128)] + [
    (npc, (1, 7, 2049)[i % 3], keep, (1, 8, 16)[i // 3 % 3],
     (1, 100, 128)[(i + 1) % 3]) for i, (npc, keep) in enumerate(_S5_GRID)]


@pytest.mark.parametrize("npc,nq,keep,t,sub", _S5_CASES)
def test_y_bitonic_kernel_identical(dev, npc, nq, keep, t, sub):
    """Both S5 forms against their plain versions on y with many ties
    across subgroups: the pairs form's group ids in the TPU network's
    order."""
    from vectorsearch_rbac_tpu_torch.ops import lab_merge

    rng = np.random.default_rng(npc + keep)
    y = (rng.integers(0, 40, size=(npc, nq)) * 128
         + rng.integers(0, sub, size=(npc, nq))).astype(np.int32)
    y = torch.from_numpy(y).to(dev)
    before = dict(_build.LAUNCHES)
    ys = lab_merge.bitonic_sort_keep(y, keep)
    yp, gp = lab_merge.bitonic_pairs_keep(y, keep, t, sub)
    assert _build.LAUNCHES["merge_y_sort"] == before["merge_y_sort"] + 1
    assert _build.LAUNCHES["merge_y_pairs"] == before["merge_y_pairs"] + 1
    ys_p = lab_merge.bitonic_sort_keep_plain(y, keep)
    yp_p, gp_p = lab_merge.bitonic_pairs_keep_plain(y, keep, t, sub)
    torch.cuda.synchronize()
    assert torch.equal(ys, ys_p) and torch.equal(yp, yp_p)
    assert torch.equal(gp, gp_p) and torch.equal(ys, yp)


@pytest.mark.parametrize("npc,t,sub", [(512, 8, 128), (2048, 16, 2),
                                       (64, 1, 1)])
def test_y_bitonic_kernel_equal_y_across_subgroups(dev, npc, t, sub):
    """S5's pairs form where only the tie rule orders the gids: two scores
    and positions 0 and 1 only, so most y recur in many subgroups, and
    whole columns of one y. The gids must be the plain version's (the
    TPU network's order) in every row, the sort form's values too."""
    from vectorsearch_rbac_tpu_torch.ops import lab_merge

    nq = 70
    rng = np.random.default_rng(npc + t)
    y = (rng.integers(0, 2, size=(npc, nq)) * 128
         + rng.integers(0, min(sub, 2), size=(npc, nq))).astype(np.int32)
    y[:, 5] = 3 * 128                            # one y in every row
    y[:, 6] = np.iinfo(np.int32).max             # the drained sentinel
    y = torch.from_numpy(y).to(dev)
    yp, gp = lab_merge.bitonic_pairs_keep(y, npc, t, sub)
    ys = lab_merge.bitonic_sort_keep(y, npc)
    yp_p, gp_p = lab_merge.bitonic_pairs_keep_plain(y, npc, t, sub)
    torch.cuda.synchronize()
    assert torch.equal(yp, yp_p) and torch.equal(gp, gp_p)
    assert torch.equal(ys, yp_p)
    assert len(torch.unique(gp_p[:, 5])) == npc // t


def test_lab_merges_cuda_equal_cpu(dev):
    """extract_merge and extract_merge_v2 on the card (S4, S5) equal the
    same merges on the CPU (plain versions)."""
    from vectorsearch_rbac_tpu_torch.ops import lab_merge

    p = _packed_with_ties(np.random.default_rng(3), 8192, 200)
    got = {}
    for d in (dev, torch.device("cpu")):
        mins = torch.from_numpy(p).to(d)
        got[d.type] = (lab_merge.extract_merge(mins, 100, 128, 16),
                       lab_merge.extract_merge_v2(mins, 100, 128, 8, 128))
    for (a, b), (c, e) in zip(got["cuda"], got["cpu"]):
        assert torch.equal(a.cpu(), c) and torch.equal(b.cpu(), e)
