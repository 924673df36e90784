"""Traffic kind `closed_loop`: one caller that sends its next call when
the last one has returned.

A mix of this kind gives:
- `queries_per_call`: queries in one `search_batch` call;
- `k`: results a query;
- `distinct_calls`: calls drawn from the seed before the window; the
  window sends them in turn, over and over (the program keeps no state
  from call to call, so a repeat costs what a fresh draw costs, and the
  check can judge every answer);
- `queries`: "pool", uniform draws from the corpus's held-out pool,
  without replacement within a call where the pool is large enough, as
  the reference's generate_query_workload draws them;
- `users`: "uniform", each query's user uniform over the world's users,
  with replacement (generate_query_workload's draw).

The window times each call from just before the search to its host arrays
in hand, and runs from the first call's start to the last call's end:
calls are sent while less than `seconds` has passed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np
from torch.profiler import record_function

from rbacbench.trace import CALL_SPAN


@dataclass
class Call:
    bank: int
    t0: float
    t1: float
    ids: np.ndarray


@dataclass
class Window:
    calls: List[Call] = field(default_factory=list)
    t0: float = 0.0
    t1: float = 0.0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def answered(self) -> int:
        return sum(len(c.ids) for c in self.calls)


def bank(mix: Mapping, pool: np.ndarray, num_users: int, seed_seq
         ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The mix's distinct calls: [(queries (Q, d) float32, user ids (Q,)
    int64)], call b drawn from seed_seq's b-th child."""
    if mix.get("queries") != "pool" or mix.get("users") != "uniform":
        raise ValueError("closed_loop draws pool queries for uniform users")
    nq = int(mix["queries_per_call"])
    out = []
    for child in seed_seq.spawn(int(mix["distinct_calls"])):
        rng = np.random.default_rng(child)
        sel = rng.choice(len(pool), size=nq, replace=nq > len(pool))
        users = rng.choice(num_users, size=nq, replace=True)
        out.append((np.ascontiguousarray(pool[sel], dtype=np.float32),
                    users.astype(np.int64)))
    return out


def run(mix: Mapping, calls: List[Tuple[np.ndarray, np.ndarray]],
        search: Callable, seconds: float,
        traced: Optional[Callable[[Callable[[], None]], None]] = None,
        traced_calls: int = 3) -> Window:
    """Send the calls in turn for `seconds`. With `traced`, once half the
    time has passed (or at the end of a window too short for that),
    `traced_calls` calls run inside traced(block)."""
    k = int(mix["k"])
    win = Window()
    clock = time.perf_counter

    def one(i: int) -> None:
        b = i % len(calls)
        q, users = calls[b]
        with record_function(CALL_SPAN):
            t0 = clock()
            _, ids = search(q, users, k)
            t1 = clock()
        win.calls.append(Call(bank=b, t0=t0, t1=t1, ids=ids))

    win.t0 = clock()
    i = 0
    while clock() - win.t0 < seconds:
        if traced is not None and clock() - win.t0 >= seconds / 2:
            start = i

            def block() -> None:
                for j in range(start, start + traced_calls):
                    one(j)

            traced(block)
            traced = None
            i += traced_calls
            continue
        one(i)
        i += 1
    if traced is not None:   # a window shorter than two calls
        traced(lambda: [one(j) for j in range(i, i + traced_calls)])
    win.t1 = clock()
    return win
