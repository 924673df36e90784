"""A merge kernel of other merge sources against the checkout's, on the card,
in turns: the bitonic sort (K4) or the y-form extraction (S4).

    python -m vectorsearch_rbac_tpu_torch.bench.merge_ab \
        --source parent=state/ab/merge_parent.cu [--source LABEL=PATH ...] \
        [--kernel k4|s4]

Each PATH is a copy of csrc/merge.cu (another commit's, say `git show
REV:vectorsearch_rbac_tpu_torch/csrc/merge.cu`, or a variant of it), built
with nvcc into its own library beside the source and bound by the
kernel's C entry. K4 (`vsr_bitonic_pairs`, the default): for each shape
(npc 512: keep 104 and 136 at 2048 queries, the paths' top-100 and 768-d
widths; keep 16 at 1024, top-10's) the survivors come from the checkout's
extraction kernel on random packed minima. S4 (`vsr_y_extract`): 8192
random packed minima groups x 2048 queries, sub 128, t 8, 16 and 32 (the
smoke's shape at t 8). Every source runs the kernel in turns (each source,
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

from ..ops import _build, lab_merge, merge
from .lab import card_line, cuda_ms

SHAPES = ((2048, 104), (2048, 136), (1024, 16))   # (queries, keep) at npc 512
NPC = 512
S4_SHAPES = ((2048, 8), (2048, 16), (2048, 32))   # (queries, t) at sub 128
S4_GROUPS, S4_SUB = 8192, 128
ENTRIES = {"k4": "vsr_bitonic_pairs", "s4": "vsr_y_extract"}


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
    cases = k4_cases if args.kernel == "k4" else s4_cases
    for shape, ours, theirs in cases(dev, np.random.default_rng(0)):
        want = ours()
        for label, lib in libs.items():
            fn = lambda lib=lib: theirs(lib)
            got = fn()
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
