"""The port's kernel lab (ops/lab_scan.py, ops/lab_merge.py) against the
lab kernels it replaces, loaded from scripts/ by path and run in Pallas
interpret mode on the CPU.

On the CPU the port runs each kernel's plain version, so these tests hold
the plain versions bit-identical to the lab's TPU kernels: K1's trim and
floor epilogues (scripts/r4_kernel_variants.py, S1; trim's control, the
chain, against the reference K1 itself), the y-form subgroup
extraction (scripts/r4_extract_kernel.py, S4) and both forms of the y-form
bitonic sort (scripts/r4_bitonic_kernel.py, S5), and the two merges built
from them. The one place the port departs from the lab on purpose, the
sentinel of a subgroup that runs out of admissible groups, has a test of
its own."""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.core import bits_to_onehot8
from vectorsearch_rbac_tpu_torch.ops import lab_merge, lab_scan
from vectorsearch_rbac_tpu_torch.ops.merge import INT32_MAX

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
N, D, R, Q = 8192, 128, 128, 64


@pytest.fixture(scope="module")
def lab():
    """The lab modules, imported from scripts/ by path (the extraction
    module imports the bitonic one by name, so scripts/ joins sys.path for
    the module's tests)."""
    sys.path.insert(0, str(SCRIPTS))
    mods = {}
    try:
        for name in ("r4_kernel_variants", "r4_bitonic_kernel",
                     "r4_extract_kernel"):
            spec = importlib.util.spec_from_file_location(
                name, SCRIPTS / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
            mods[name] = mod
        yield mods
    finally:
        sys.path.remove(str(SCRIPTS))
        for name in mods:
            sys.modules.pop(name, None)


@pytest.fixture(scope="module")
def scan_prob():
    rng = np.random.default_rng(0)
    vecs = rng.integers(-100, 100, size=(N, D)).astype(np.int8)
    norms = np.einsum("nd,nd->n", vecs.astype(np.int64),
                      vecs.astype(np.int64)).astype(np.int32)
    roles = rng.random((N, R)) < 0.05
    roles[:, 0] |= rng.random(N) < 0.3            # a popular role
    queries = rng.integers(-100, 100, size=(Q, D)).astype(np.int8)
    masks = rng.random((Q, R)) < 0.1
    masks[:, 0] = True
    masks[3] = False                              # one query sees nothing
    pack = lambda b: np.packbits(b, axis=1, bitorder="little").view(np.uint32)
    return vecs, norms, pack(roles), queries, pack(masks)


@pytest.mark.parametrize("variant,metric,shift", [
    ("trim", "l2", 0), ("trim", "ip", 0), ("trim", "l2", 3),
    ("floor", "l2", 0)])
def test_scan_variants_bit_identical(lab, scan_prob, variant, metric, shift):
    """The plain trim (K1's minima) and floor probe against the lab's
    int8_masked_topk_lab(merge="none") in interpret mode, fed the bitsets'
    one-hot expansion."""
    vecs, norms, rbits, queries, qbits = scan_prob
    want, _ = lab["r4_kernel_variants"].int8_masked_topk_lab(
        jnp.asarray(queries), jnp.zeros(Q, jnp.int32), jnp.asarray(vecs),
        jnp.asarray(norms), jnp.asarray(bits_to_onehot8(rbits, R, R)),
        jnp.asarray(bits_to_onehot8(qbits, R, R)), jnp.float32(1.0), 10,
        group=128, merge="none", interpret=True, metric=metric,
        score_shift=shift, variant=variant)
    t = torch.from_numpy
    got, again = lab_scan.int8_masked_topk_lab(
        t(queries), None, t(vecs), t(norms), t(rbits.view(np.int32)),
        t(qbits.view(np.int32)), 1.0, 10, group=128, merge="none",
        metric=metric, score_shift=shift, variant=variant)
    assert got is again and got.shape == (N // 128, Q)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("metric,shift", [("l2", 0), ("ip", 0), ("l2", 3)])
def test_chain_matches_reference_k1(scan_prob, metric, shift):
    """The chain (trim's control: the reference K1's literal epilogue on
    K1's schedule) on CPU tensors against the reference K1 itself,
    int8_masked_topk(merge="none") in interpret mode, fed the bitsets'
    one-hot expansion."""
    from vectorsearch_rbac_tpu.ops.pallas_scan_int8 import int8_masked_topk

    vecs, norms, rbits, queries, qbits = scan_prob
    want, _ = int8_masked_topk(
        jnp.asarray(queries), jnp.zeros(Q, jnp.int32), jnp.asarray(vecs),
        jnp.asarray(norms), jnp.asarray(bits_to_onehot8(rbits, R, R)),
        jnp.asarray(bits_to_onehot8(qbits, R, R)), jnp.float32(1.0), 10,
        q_tile=Q, group=128, merge="none", interpret=True, metric=metric,
        score_shift=shift)
    t = torch.from_numpy
    got = lab_scan.lab_group_minima(
        t(queries), t(vecs), t(norms), t(rbits.view(np.int32)),
        t(qbits.view(np.int32)), group=128, metric=metric,
        score_shift=shift, variant="chain")
    assert got.shape == (N // 128, Q)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_trim_merges_like_k1(scan_prob):
    """trim's minima are K1's, so its merged results are K1's too."""
    from vectorsearch_rbac_tpu_torch.ops.scan_int8 import int8_masked_topk

    vecs, norms, rbits, queries, qbits = scan_prob
    t = torch.from_numpy
    qn = t((queries.astype(np.int64) ** 2).sum(1).astype(np.int32))
    args = (t(queries), qn, t(vecs), t(norms), t(rbits.view(np.int32)),
            t(qbits.view(np.int32)), 1.0, 10)
    want = int8_masked_topk(*args, group=64, merge="cascade")
    got = lab_scan.int8_masked_topk_lab(*args, group=64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="not one of"):
        lab_scan.lab_group_minima(*args[:1], *args[2:6], variant="unroll")


@pytest.mark.parametrize("metric,shift", [("l2", 0), ("ip", 3)])
def test_dp4a_variant_is_k1_plain(scan_prob, metric, shift):
    """The lab's dp4a K1 (the old design) and the chain (trim's control)
    have K1's plain minima as their CPU path and counters of their own; an
    unknown variant is refused."""
    from vectorsearch_rbac_tpu_torch.ops import _build
    from vectorsearch_rbac_tpu_torch.ops.scan_int8 import (
        int8_group_minima_plain)

    vecs, norms, rbits, queries, qbits = scan_prob
    t = torch.from_numpy
    rows = (t(queries), t(vecs), t(norms), t(rbits.view(np.int32)),
            t(qbits.view(np.int32)))
    kw = dict(group=32, metric=metric, score_shift=shift)
    want = int8_group_minima_plain(*rows, **kw)
    for variant in ("dp4a", "chain"):
        got = lab_scan.lab_group_minima(*rows, variant=variant, **kw)
        assert torch.equal(got, want)
    assert lab_scan.VARIANTS["dp4a"] == 0
    assert set(lab_scan.VARIANTS) == {"dp4a", "trim", "floor", "chain"}
    assert all(f"scan_int8_{v}" in _build.LAUNCHES for v in lab_scan.VARIANTS)
    with pytest.raises(ValueError, match="not one of"):
        lab_scan.lab_group_minima(*rows, variant="plain", **kw)


def _packed(ng, nq, seed, lo=1 << 18, hi=1 << 29):
    """Random packed minima as the lab's merge scripts make them
    (r4_merge_lab4.py:29-32): scores in [lo, hi), random lanes."""
    rng = np.random.default_rng(seed)
    p = rng.integers(lo, hi, size=(ng, nq), dtype=np.int64).astype(np.int32)
    p &= ~np.int32(127)
    p |= rng.integers(0, 128, size=(ng, nq), dtype=np.int64).astype(np.int32)
    return p


@pytest.mark.parametrize("sub,t", [(128, 16), (128, 8), (64, 8), (32, 8)])
def test_subgroup_extract_bit_identical(lab, sub, t):
    mins = _packed(1024, 32, seed=sub + t)
    want = lab["r4_extract_kernel"].subgroup_extract(
        jnp.asarray(mins), sub=sub, t=t, interpret=True)
    got = lab_merge.subgroup_extract(torch.from_numpy(mins), sub, t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sub,t", [(128, 1), (32, 5), (8, 40), (128, 48)])
def test_y_extract_any_t(sub, t):
    """S4's kernel wrapper takes any t >= 1 (the lab's entry takes
    multiples of 8): its rows are the sorted y of each subgroup cut at t,
    padded with INT32_MAX past sub."""
    nq = 8
    mins = _packed(256, nq, seed=sub + t)
    mins[:sub] = 0x7F000000              # a subgroup of inadmissible groups
    got = lab_merge.y_extract(torch.from_numpy(mins), sub, t).numpy()
    y = (mins.reshape(-1, sub, nq) & ~np.int32(127)) | np.arange(
        sub, dtype=np.int32)[None, :, None]
    want = np.full((256 // sub, t, nq), INT32_MAX, np.int32)
    want[:, :min(t, sub)] = np.sort(y, axis=1)[:, :t]
    np.testing.assert_array_equal(got, want.reshape(-1, nq))
    with pytest.raises(ValueError):
        lab_merge.y_extract(torch.from_numpy(mins), sub, 0)


def test_subgroup_extract_refuses_lab_breaking_shapes():
    mins = torch.from_numpy(_packed(512, 8, seed=1))
    for sub, t in ((256, 8), (100, 8), (128, 12)):
        with pytest.raises(ValueError):
            lab_merge.subgroup_extract(mins, sub, t)


@pytest.mark.parametrize("sub,t,keep", [(128, 8, 128), (128, 16, 104),
                                        (64, 8, 64)])
def test_bitonic_forms_bit_identical(lab, sub, t, keep):
    """Both S5 forms on the extraction's output, with scores from a narrow
    range so that equal y of different subgroups are common: the pairs
    form must order their group ids as the TPU network does."""
    mins = _packed(2048, 16, seed=keep, lo=1 << 18, hi=(1 << 18) + 64 * 128)
    y = lab_merge.subgroup_extract(torch.from_numpy(mins), sub, t)
    yn = y.numpy()
    assert len(np.unique(yn[:, 0])) < len(yn[:, 0])          # ties
    bit = lab["r4_bitonic_kernel"]
    want = bit.bitonic_sort_keep(jnp.asarray(yn), keep=keep, interpret=True)
    got = lab_merge.bitonic_sort_keep(y, keep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_y, want_g = bit.bitonic_pairs_keep(jnp.asarray(yn), keep=keep, t=t,
                                            sub=sub, interpret=True)
    got_y, got_g = lab_merge.bitonic_pairs_keep(y, keep, t, sub)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))


@pytest.mark.parametrize("t", [16, 8])
def test_extract_merge_matches_lab(lab, t):
    mins = _packed(4096, 16, seed=t)
    want = lab["r4_extract_kernel"].extract_merge(
        jnp.asarray(mins), 100, sub=128, t=t, interpret=True)
    got = lab_merge.extract_merge(torch.from_numpy(mins), 100, 128, t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("sub,t,keep", [(128, 8, 128), (64, 8, 128),
                                        (128, 8, 104)])
def test_extract_merge_v2_matches_lab(lab, sub, t, keep):
    mins = _packed(4096, 16, seed=sub + keep)
    want = lab["r4_extract_kernel"].extract_merge_v2(
        jnp.asarray(mins), 100, sub=sub, t=t, keep=keep, interpret=True)
    got = lab_merge.extract_merge_v2(torch.from_numpy(mins), 100, sub, t,
                                     keep)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_drained_subgroup_sentinel(lab):
    """A subgroup with fewer admissible groups than t rounds: the lab
    kernel emits 2^30 once they are out, which decodes to position 0, so
    extract_merge returns that group twice; the port emits the
    inadmissible values in order, then INT32_MAX, and its merge returns
    each group once, the drained slots empty. The rounds before the
    subgroup drains agree bit for bit."""
    ng, nq, sub, t, k = 256, 8, 128, 8, 12
    mins = _packed(ng, nq, seed=5)
    mins[sub + 3:] = 0x7F000000          # subgroup 1: 3 admissible groups
    want = np.asarray(lab["r4_extract_kernel"].subgroup_extract(
        jnp.asarray(mins), sub=sub, t=t, interpret=True))
    got = lab_merge.subgroup_extract(torch.from_numpy(mins), sub, t).numpy()
    np.testing.assert_array_equal(got[:t + 3], want[:t + 3])
    assert (want[t + 3:] == 1 << 30).all()
    assert (got[t + 3:] == (0x7F000000 | np.arange(3, t)[:, None])).all()
    assert (got[t + 3:] != want[t + 3:]).all()

    _, lab_pos = lab["r4_extract_kernel"].extract_merge(
        jnp.asarray(mins), k, sub=sub, t=t, interpret=True)
    vals, pos = lab_merge.extract_merge(torch.from_numpy(mins), k, sub, t)
    lab_pos = np.asarray(lab_pos)
    assert all(len(set(row)) < k for row in lab_pos)          # duplicates
    for row, v in zip(pos.numpy(), vals.numpy()):
        real = v < 0x7E000000
        assert real.sum() == k - 1 and len(set(row[real])) == k - 1
    # a subgroup past its sub values emits INT32_MAX
    y = lab_merge.subgroup_extract(torch.from_numpy(mins[:64]), 8, 16)
    assert (y.view(8, 16, nq)[:, 8:] == INT32_MAX).all()


def test_lab_entry_refuses_cpu_and_unknown_legs():
    """The lab measures the card: without CUDA it exits 2 and prints no
    result line; a leg it does not have is refused by its parser."""
    import subprocess

    from vectorsearch_rbac_tpu_torch.bench import lab as lab_entry

    repo = str(SCRIPTS.parent)
    out = subprocess.run([sys.executable, "-m",
                          "vectorsearch_rbac_tpu_torch.bench.lab", "merge"],
                         cwd=repo, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""
    with pytest.raises(SystemExit):
        lab_entry.main(["tunnel"])


def test_merge_ab_refuses_cpu_and_needs_a_source():
    """The K4 A/B measures the card: without CUDA it returns 2 before it
    builds anything; without a --source its parser refuses."""
    from vectorsearch_rbac_tpu_torch.bench import merge_ab

    assert merge_ab.main(["--source", "other=no/such/merge.cu"]) == 2
    with pytest.raises(SystemExit):
        merge_ab.main([])


@pytest.mark.parametrize("kernel", ["k4", "s4", "s5", "k1", "k2"])
def test_merge_ab_kernels_refuse_cpu(kernel):
    """Each kernel the merge A/B times (K4, S4, S5) is a choice of its
    parser, and without CUDA each returns 2 before it builds anything."""
    from vectorsearch_rbac_tpu_torch.bench import merge_ab

    assert set(merge_ab.CASES) == set(merge_ab.ENTRIES) == {
        "k4", "s4", "s5", "k1", "k2"}
    assert merge_ab.main(["--source", "other=no/such/merge.cu",
                          "--kernel", kernel]) == 2


@pytest.mark.parametrize("npc,keep", [(2, 1), (2, 2), (16, 5), (64, 1),
                                      (2048, 2048)])
def test_bitonic_forms_take_any_keep(npc, keep):
    """S5's wrappers take every shape its kernel takes (npc a power of two
    in [2, 2048], 1 <= keep <= npc): the sort form is the first `keep`
    rows of each sorted column, the pairs form the same values with their
    group ids; other shapes are refused."""
    rng = np.random.default_rng(npc + keep)
    y = torch.from_numpy((rng.integers(0, 9, (npc, 5)) * 128 + rng.integers(
        0, 4, (npc, 5))).astype(np.int32))
    want = torch.sort(y, dim=0).values[:keep]
    assert torch.equal(lab_merge.bitonic_sort_keep(y, keep), want)
    got_y, got_g = lab_merge.bitonic_pairs_keep(y, keep, 2, 4)
    assert torch.equal(got_y, want)
    assert torch.equal(got_g % 4, got_y & 127)   # gid % sub: the position
    for bad_npc, bad_keep in ((npc, 0), (npc, npc + 1), (1, 1), (4096, 8),
                              (24, 8)):
        with pytest.raises(ValueError):
            lab_merge.bitonic_sort_keep(torch.zeros((bad_npc, 3),
                                                    dtype=torch.int32),
                                        bad_keep)
