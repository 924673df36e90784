"""A kernel of other sources against the checkout's, on the card, in turns:
the bitonic sort (K4), the y-form extraction (S4) or the y-form bitonic
sort (S5) of csrc/merge.cu, or the narrow (K1) or wide (K2) scan.

    python -m vectorsearch_rbac_tpu_torch.bench.merge_ab \
        --source parent=state/ab/merge_parent.cu [--source LABEL=PATH ...] \
        [--kernel k4|s4|s5|k1|k2]

Each PATH is a copy of csrc/merge.cu, or for K1 and K2 of
csrc/scan_int8.cu or csrc/scan_int8_wide.cu with the csrc/tma_wgmma.cuh
it includes beside it (another commit's, say `git show
REV:vectorsearch_rbac_tpu_torch/csrc/merge.cu`, or a variant of it), built
with nvcc into its own library beside the source and bound by the
kernel's C entry. K4 (`vsr_bitonic_pairs`, the default): for each shape
(npc 512: keep 104 and 136 at 2048 queries, the paths' top-100 and 768-d
widths; keep 16 at 1024, top-10's) the survivors come from the checkout's
extraction kernel on random packed minima. S4 (`vsr_y_extract`): 8192
random packed minima groups x 2048 queries, sub 128, t 8, 16 and 32 (the
smoke's shape at t 8). S5 (`vsr_bitonic_y`): its sort and pairs forms on
the checkout's extraction of the same minima at t 8 (npc 512, 2048
queries, keep 128, sub 128: the smoke's shape). K1 (`vsr_scan_int8`) and
K2 (`vsr_scan_int8_wide`): 2048 queries x 1,048,576 rows at d_pad 128 and
768, group 128, W 4, 10 and 32, random int8 codes and bitsets (5% of a
row's roles, 10% of a query's), the l2 and ip kernel metrics at score
shift 0 and 3 (the smoke's shapes), per-query masks and, at W 4, the
slot form in both layouts (slots of 16, contiguous and interleaved in
tiles of 512); a source that refuses a shape (an older one past W 8) is
skipped there. Every source runs the kernel in turns (each source,
the checkout, the checkout, each source) and its output is compared with
the checkout's. Times are CUDA events around launches queued behind a spin
on the card, so a wrapper's host dispatch is not timed. One JSON line per
(shape, source) on stdout, with the card's name and power limit. It needs
a CUDA device and exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import _build, lab_merge, merge, scan_int8
from .lab import card_line, cuda_ms

SHAPES = ((2048, 104), (2048, 136), (1024, 16))   # (queries, keep) at npc 512
NPC = 512
S4_SHAPES = ((2048, 8), (2048, 16), (2048, 32))   # (queries, t) at sub 128
S4_GROUPS, S4_SUB = 8192, 128
S5_T, S5_KEEP = 8, 128
SCAN_Q, SCAN_ROWS, SCAN_GROUP = 2048, 1 << 20, 128
SCAN_WORDS = (4, 10, 32)
SCAN_SLOTS = ((0, 0), (16, 0), (16, 512))  # (mask_sb, slot_tile) at W 4
ENTRIES = {"k4": "vsr_bitonic_pairs", "s4": "vsr_y_extract",
           "s5": "vsr_bitonic_y", "k1": "vsr_scan_int8",
           "k2": "vsr_scan_int8_wide"}


def build(src: Path, entry: str) -> ctypes.CDLL:
    so = src.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(so), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(so.resolve()))
    fn = getattr(lib, entry)
    fn.argtypes = _build._SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return lib


def packed_minima(rng, ng: int, nq: int) -> np.ndarray:
    mins = rng.integers(1 << 18, 1 << 29, size=(ng, nq)).astype(
        np.int32) & ~np.int32(127)
    mins |= rng.integers(0, 128, size=(ng, nq)).astype(np.int32)
    return mins


def k4_cases(dev, rng):
    """(shape, the checkout's call, a source's call on its library)."""
    for nq, keep in SHAPES:
        mins = packed_minima(rng, 8192, nq)
        y, meta = merge.extract_pairs(torch.from_numpy(mins).to(dev), 32, 16)
        out_y = torch.empty((keep, nq), dtype=torch.int32, device=dev)
        out_m = torch.empty_like(out_y)

        def theirs(lib, y=y, meta=meta, out_y=out_y, out_m=out_m, nq=nq,
                   keep=keep):
            err = lib.vsr_bitonic_pairs(
                y.data_ptr(), meta.data_ptr(), out_y.data_ptr(),
                out_m.data_ptr(), nq, NPC, keep, _build.stream_ptr(dev))
            if err:
                raise RuntimeError(f"vsr_bitonic_pairs: CUDA error {err}")
            return out_y, out_m

        yield ({"npc": NPC, "keep": keep, "nq": nq},
               lambda y=y, meta=meta, keep=keep: merge.bitonic_pairs(
                   y, meta, keep), theirs)


def s4_cases(dev, rng):
    mins = torch.from_numpy(packed_minima(rng, S4_GROUPS, S4_SHAPES[0][0])
                            ).to(dev)
    for nq, t in S4_SHAPES:
        out = torch.empty((S4_GROUPS // S4_SUB * t, nq), dtype=torch.int32,
                          device=dev)

        def theirs(lib, t=t, out=out, nq=nq):
            err = lib.vsr_y_extract(mins.data_ptr(), out.data_ptr(), nq,
                                    S4_GROUPS // S4_SUB, S4_SUB, t,
                                    _build.stream_ptr(dev))
            if err:
                raise RuntimeError(f"vsr_y_extract: CUDA error {err}")
            return (out,)

        yield ({"groups": S4_GROUPS, "sub": S4_SUB, "t": t, "nq": nq},
               lambda t=t: (lab_merge.subgroup_extract(mins, S4_SUB, t),),
               theirs)


def s5_cases(dev, rng):
    nq = S4_SHAPES[0][0]
    mins = torch.from_numpy(packed_minima(rng, S4_GROUPS, nq)).to(dev)
    y = lab_merge.subgroup_extract(mins, S4_SUB, S5_T)
    npc = y.shape[0]
    out_y = torch.empty((S5_KEEP, nq), dtype=torch.int32, device=dev)
    out_g = torch.empty_like(out_y)
    for pairs in (0, 1):

        def theirs(lib, pairs=pairs):
            err = lib.vsr_bitonic_y(y.data_ptr(), out_y.data_ptr(),
                                    out_g.data_ptr() if pairs else None, nq,
                                    npc, S5_KEEP, S5_T, S4_SUB, pairs,
                                    _build.stream_ptr(dev))
            if err:
                raise RuntimeError(f"vsr_bitonic_y: CUDA error {err}")
            return (out_y, out_g) if pairs else (out_y,)

        ours = ((lambda: lab_merge.bitonic_pairs_keep(y, S5_KEEP, S5_T,
                                                      S4_SUB)) if pairs
                else (lambda: (lab_merge.bitonic_sort_keep(y, S5_KEEP),)))
        yield ({"form": "pairs" if pairs else "sort", "npc": npc,
                "keep": S5_KEEP, "t": S5_T, "sub": S4_SUB, "nq": nq},
               ours, theirs)


def scan_cases(kernel: str):
    """K1's or K2's cases: the smoke's shape on random operands, at each
    of SCAN_WORDS bitset words."""
    d_pad, l2, shift = (128, 1, 0) if kernel == "k1" else (768, 0, 3)
    metric = "l2" if l2 else "ip"
    scan = (scan_int8.int8_group_minima if kernel == "k1"
            else scan_int8.int8_group_minima_wide)

    def cases(dev, rng):
        gen = torch.Generator(device=dev).manual_seed(int(rng.integers(
            1 << 30)))

        def bits(n, w, p):   # (n, w) int32 words, each bit set with p
            on = torch.rand((n, w, 32), device=dev, generator=gen) < p
            words = (on.to(torch.int64) << torch.arange(32, device=dev)).sum(2)
            return (words - (words >= 2**31).to(torch.int64) * 2**32).to(
                torch.int32).contiguous()

        q8 = torch.randint(-128, 128, (SCAN_Q, d_pad), device=dev,
                           dtype=torch.int8, generator=gen)
        x8 = torch.randint(-128, 128, (SCAN_ROWS, d_pad), device=dev,
                           dtype=torch.int8, generator=gen)
        norms = (x8.to(torch.int32) ** 2).sum(1, dtype=torch.int32)
        out = torch.empty((SCAN_ROWS // SCAN_GROUP, SCAN_Q),
                          dtype=torch.int32, device=dev)
        shapes = [(w, 0, 0) for w in SCAN_WORDS] + [
            (SCAN_WORDS[0], sb, tile) for sb, tile in SCAN_SLOTS if sb]
        for w, sb, tile in shapes:
            ops = (q8, x8, norms, bits(SCAN_ROWS, w, 0.05 * 4 / w),
                   bits(SCAN_Q // (sb or 1), w, 0.1 * 4 / w))
            kw = dict(group=SCAN_GROUP, metric=metric, score_shift=shift,
                      mask_sub_block=sb, slot_tile=tile)

            def theirs(lib, ops=ops, w=w, sb=sb, tile=tile):
                err = getattr(lib, ENTRIES[kernel])(
                    *(t.data_ptr() for t in ops), out.data_ptr(), SCAN_Q,
                    SCAN_ROWS, d_pad, w, SCAN_GROUP, l2, shift, sb, tile,
                    _build.stream_ptr(dev))
                if err:
                    raise RefusedShape(f"{ENTRIES[kernel]}: CUDA error {err}")
                return (out,)

            yield ({"nq": SCAN_Q, "rows": SCAN_ROWS, "d_pad": d_pad, "w": w,
                    "mask_sb": sb, "slot_tile": tile, "group": SCAN_GROUP,
                    "metric": metric, "shift": shift},
                   lambda ops=ops, kw=kw: (scan(*ops, **kw),), theirs)
    return cases


class RefusedShape(RuntimeError):
    """A source's kernel refused the shape (cudaErrorInvalidValue)."""


CASES = {"k4": k4_cases, "s4": s4_cases, "s5": s5_cases,
         "k1": scan_cases("k1"), "k2": scan_cases("k2")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", required=True,
                    metavar="LABEL=PATH", help="a merge.cu to compare")
    ap.add_argument("--kernel", choices=tuple(ENTRIES), default="k4")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this A/B measures the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    libs = {}
    for item in args.source:
        label, _, path = item.partition("=")
        libs[label] = build(Path(path), ENTRIES[args.kernel])
    for shape, ours, theirs in CASES[args.kernel](dev,
                                                  np.random.default_rng(0)):
        want = ours()
        for label, lib in libs.items():
            fn = lambda lib=lib: theirs(lib)
            try:
                got = fn()
            except RefusedShape as e:
                print(json.dumps({"kernel": args.kernel, "shape": shape,
                                  "source": label, "refused": str(e),
                                  "card": card}), flush=True)
                continue
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            times = {label: [], "checkout": []}
            for who in (label, "checkout", "checkout", label):
                times[who].append(cuda_ms(fn if who == label else ours,
                                          args.reps))
            print(json.dumps({"kernel": args.kernel, "shape": shape,
                              "source": label, "ms": times[label],
                              "checkout_ms": times["checkout"],
                              "identical": same, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
