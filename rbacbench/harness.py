"""One run of one cell: set-up, the measured window, the check, the line.

Set-up (`setup_s`, everything before the window): the corpus drawn on the
device from the seed and brought to the host once, the world, the traffic's
calls, then the program's set-up (its kernel library, timed apart as
`compile_s`; its arena and searcher) and one warm call of every distinct
call the window sends. The device's peak counter is reset between the
harness's draw (freed first) and the program's set-up, and read when the
window closes.

After the window the program's state is freed, and the reference computes
the exact filtered top-kk of every distinct query the window sent, in the
configuration's metric; every answer is judged (judge.py). `control=True`
also judges the reference over the configuration's `control` codes in the
program's place, over the same queries. A traced run's roofline work (the
pairs each call's users may read) is counted from the reference's own
readable-row counts.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import guard, judge, port, reference, roofline, trace
from .manifest import Cell, generator, reader

REF_DEPTH = 100      # the reference keeps k + REF_DEPTH rows a query


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sub_seed(seed: int, stream: int) -> int:
    """A 64-bit seed for one stream of the run's inputs."""
    return int(np.random.SeedSequence([int(seed), stream]
                                      ).generate_state(1, np.uint64)[0])


@dataclass
class Run:
    """What the end-to-end readers read."""
    window: object
    setup_s: float
    peak_bytes: int
    verdict: judge.Verdict


def _device_info(device, chips: int, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": peak}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, wrap_search: Optional[Callable] = None,
             control: bool = False) -> dict:
    cfg, mix, wl = cell.config, cell.mix, cell.workload
    k = int(mix["k"])
    cuda = device.type == "cuda"

    # -- the harness's inputs, from the seed
    t0 = time.perf_counter()
    corpus = generator("corpora", cfg["corpus"]["kind"]).make(
        cfg["corpus"], sub_seed(seed, 0), device)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    t_corpus = time.perf_counter() - t0
    world = generator("worlds", cfg["world"]["kind"]).make(
        cfg["world"], corpus.num_docs, sub_seed(seed, 1))
    traffic = generator("traffic", mix["kind"])
    calls = traffic.bank(mix, corpus.pool, world.num_users,
                        np.random.SeedSequence([int(seed), 2]))
    t_inputs = time.perf_counter() - t0

    # -- the program's set-up
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    built = port.compile_kernels() if cuda else {"compile_s": 0.0,
                                                 "was_built": True}
    t1 = time.perf_counter()
    system = port.build(cfg, corpus, world, device)
    t_build = time.perf_counter() - t1
    search = system.search if wrap_search is None else wrap_search(
        system.search)
    t1 = time.perf_counter()
    for q, users in calls:
        search(q, users, k)
    t_warm = time.perf_counter() - t1
    setup_s = time.perf_counter() - t_start
    say(f"set-up {setup_s:.3f} s: inputs {t_inputs:.3f} (corpus on the "
        f"device {t_corpus:.3f}), kernels {built['compile_s']:.3f} "
        f"({'loaded' if built['was_built'] else 'compiled'}), program "
        f"{t_build:.3f}, warm-up {t_warm:.3f} ({len(calls)} calls)")

    # -- the window
    summary = None
    tracer = None
    if traced:
        seg: Dict[str, object] = {}

        def tracer(block):
            prof = trace.profiler()
            with prof, torch.profiler.record_function(trace.WINDOW_SPAN):
                seg["p0"] = time.perf_counter()
                block()
                seg["p1"] = time.perf_counter()
            seg["prof"] = prof

    window = traffic.run(mix, calls, search, seconds, tracer)
    guard.check("window closed")
    walls = np.array([c.t1 - c.t0 for c in window.calls]) * 1000.0
    thirds = [f"{w.mean():.2f}" for w in np.array_split(walls, 3) if len(w)]
    say(f"window {window.seconds:.3f} s, {len(walls)} calls: ms min "
        f"{walls.min():.2f} median {np.median(walls):.2f} max "
        f"{walls.max():.2f}; mean by thirds {' '.join(thirds)}")
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    dev_info = _device_info(device, cell.chips, peak)
    if traced:
        summary = trace.summarize(trace.events(seg.pop("prof")))
        summary.kind = dev_info["kind"]
        for name in sorted(summary.span_host_s):
            say(f"span {name}: host {summary.span_host_s[name]:.6f} s, "
                f"device {summary.span_device_s.get(name, 0.0):.6f} s "
                f"({summary.calls} calls)")
    system.close()
    del search, system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the check
    t1 = time.perf_counter()
    rows = torch.from_numpy(corpus.rows).to(device)
    doc_of_row = torch.from_numpy(corpus.doc_ids.astype(np.int64)).to(device)
    doc_bits = torch.from_numpy(world.doc_role_bits.view(np.int32)).to(device)
    all_q = np.concatenate([q for q, _ in calls])
    all_m = world.user_masks[np.concatenate([u for _, u in calls])]
    dist = reference.metric(cfg["metric"])
    ref_d, _, n_read = reference.filtered_topk(
        rows, doc_of_row, doc_bits, all_m, all_q, k + REF_DEPTH,
        cfg["metric"])
    nq = len(calls[0][0])

    def judged(answers) -> judge.Verdict:
        v = judge.Verdict()
        for b, seen in judge.distinct_answers(answers).items():
            sl = slice(b * nq, (b + 1) * nq)
            for ids, times in seen:
                v.add(judge.judge_batch(rows, doc_of_row, doc_bits, all_q[sl],
                                        all_m[sl], ids, ref_d[sl], n_read[sl],
                                        k, dist), times)
        return v

    verdict = judged([(c.bank, c.ids) for c in window.calls])
    say(f"check {time.perf_counter() - t1:.3f} s: {verdict.answered} answers "
        f"judged against the reference over {len(all_q)} distinct queries")
    control_verdict = None
    if control:
        _, ctl_i, _ = reference.filtered_topk(
            rows, doc_of_row, doc_bits, all_m, all_q, k, cfg["metric"],
            control=cfg["control"])
        control_verdict = judged([(b, ctl_i[b * nq:(b + 1) * nq])
                                  for b in range(len(calls))])

    # -- the line
    run = Run(window=window, setup_s=setup_s, peak_bytes=peak,
              verdict=verdict)
    metrics: Dict[str, dict] = {}
    if traced:
        n, dim = corpus.rows.shape
        summary.work = [dict(n_rows=n, n_docs=corpus.num_docs, dim=dim,
                             words=world.words, queries=len(c.ids), k=k,
                             admitted=int(n_read[c.bank * nq:
                                                 (c.bank + 1) * nq].sum()))
                        for c in window.calls
                        if seg["p0"] <= c.t0 and c.t1 <= seg["p1"]]
        for m in cell.per_layer:
            val = reader("metrics", m["name"]).read(summary)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            val = reader("endtoend", m["name"]).read(run)
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    checks = verdict.numbers()
    limits = wl["limits"]
    correct = bool(window.answered) and all(
        checks[name] <= limits[name] for name in checks)
    line = {"correct": correct, "attempted": window.answered,
            "failed": verdict.failed, "metrics": metrics, "device": dev_info}
    if traced:
        line["device"]["busy_s"] = summary.busy_s
        line["device"]["window_s"] = summary.window_s
        line["breakdown"] = trace.breakdown(summary)
    line["setup"] = {"compile_s": built["compile_s"],
                     "compiled": not built["was_built"], "inputs_s": t_inputs,
                     "program_s": t_build, "warm_s": t_warm,
                     "calls": len(window.calls),
                     "window_s": window.seconds}
    if control_verdict is not None:
        line["control"] = control_verdict.numbers()
    line["checks"] = {name: {"value": val, "limit": limits[name]}
                      for name, val in checks.items()}
    return line


def card_line() -> List[str]:
    """nvidia-smi's name and power limit of each card, where it runs."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def peaks_line(kind: str) -> str:
    p = roofline.peaks(kind)
    if p is None:
        return f"no peaks for {kind!r}: no roofline"
    return (f"peaks of {kind}: {p[0]:.4g} B/s HBM, {p[1]:.4g} int8 op/s "
            "(data sheet, 700 W)")
