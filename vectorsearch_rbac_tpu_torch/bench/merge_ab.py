"""The bitonic sort (K4) of other merge sources against the checkout's, on
the card, in turns.

    python -m vectorsearch_rbac_tpu_torch.bench.merge_ab \
        --source parent=build/ab/merge_parent.cu [--source LABEL=PATH ...]

Each PATH is a copy of csrc/merge.cu (another commit's, say `git show
REV:vectorsearch_rbac_tpu_torch/csrc/merge.cu`, or a variant of it), built
with nvcc into its own library beside the source and bound by its
`vsr_bitonic_pairs`. For each shape (npc 512: keep 104 and 136 at 2048
queries, the paths' top-100 and 768-d widths; keep 16 at 1024, top-10's)
the survivors come from the checkout's extraction kernel on random packed
minima; every source sorts them in turns (each source, the checkout, the
checkout, each source) and its output is compared with the checkout's.
Times are CUDA events around launches queued behind a spin on the card,
so a wrapper's host dispatch is not timed. One JSON line per (shape,
source) on stdout, with the card's name and power limit. It needs a CUDA
device and exits 2 without one.
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

from ..ops import _build, merge
from .lab import card_line, cuda_ms

SHAPES = ((2048, 104), (2048, 136), (1024, 16))   # (queries, keep) at npc 512
NPC = 512


def build(src: Path) -> ctypes.CDLL:
    so = src.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(so), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(so.resolve()))
    lib.vsr_bitonic_pairs.argtypes = _build._SIGNATURES["vsr_bitonic_pairs"]
    lib.vsr_bitonic_pairs.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", required=True,
                    metavar="LABEL=PATH", help="a merge.cu to compare")
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
        libs[label] = build(Path(path))
    rng = np.random.default_rng(0)
    for nq, keep in SHAPES:
        mins = rng.integers(1 << 18, 1 << 29, size=(8192, nq)).astype(
            np.int32) & ~np.int32(127)
        mins |= rng.integers(0, 128, size=(8192, nq)).astype(np.int32)
        y, meta = merge.extract_pairs(torch.from_numpy(mins).to(dev), 32, 16)
        ours = lambda: merge.bitonic_pairs(y, meta, keep)
        want_y, want_m = ours()
        for label, lib in libs.items():
            out_y = torch.empty((keep, nq), dtype=torch.int32, device=dev)
            out_m = torch.empty_like(out_y)

            def theirs(lib=lib, out_y=out_y, out_m=out_m):
                err = lib.vsr_bitonic_pairs(
                    y.data_ptr(), meta.data_ptr(), out_y.data_ptr(),
                    out_m.data_ptr(), nq, NPC, keep, _build.stream_ptr(dev))
                if err:
                    raise RuntimeError(f"{label}: CUDA error {err}")

            theirs()
            torch.cuda.synchronize()
            same = bool(torch.equal(out_y, want_y)
                        and torch.equal(out_m, want_m))
            times = {label: [], "checkout": []}
            for who in (label, "checkout", "checkout", label):
                times[who].append(cuda_ms(theirs if who == label else ours,
                                          args.reps))
            print(json.dumps({"shape": {"npc": NPC, "keep": keep, "nq": nq},
                              "source": label, "ms": times[label],
                              "checkout_ms": times["checkout"],
                              "identical": same, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
