"""Online serving front-end: a micro-batching scheduler over a searcher.

A copy of vectorsearch_rbac_tpu/serving/server.py. Many client threads
submit single queries and one dispatch thread coalesces them into device
batches: the engine is batch-synchronous, and a dispatch a query would pay
a whole launch and host round trip each.

- `submit()` is thread-safe and returns a waitable request; any number of
  client threads may call it.
- The dispatch loop blocks for the first request, then waits at most
  `max_wait_ms` for stragglers, up to `max_batch` (0 is the lowest
  latency; a larger window gives bigger batches under load).
- A drain's requests are grouped by k, one search_batch each.
- All device work runs on the dispatch thread: searchers keep host state
  and are not thread-safe.

`close()` serves what is queued, then stops the thread. `stats()` gives the
dispatches and the batch sizes; each result carries its wall latency.
`closed_loop()` drives a server with closed-loop client threads for a
window (the CLI's serve and bench.serving).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..config import get_logger

logger = get_logger("serving")


@dataclass
class SearchResult:
    dists: np.ndarray      # (k,)
    row_ids: np.ndarray    # (k,) arena rows, -1 pads
    latency_ms: float = 0.0
    batch_size: int = 0    # size of the device batch that served this


@dataclass
class SearchRequest:
    query: np.ndarray
    user_id: int
    k: int
    t_submit: float = field(default_factory=time.perf_counter)
    _event: threading.Event = field(default_factory=threading.Event)
    _result: Optional[SearchResult] = None
    _error: Optional[BaseException] = None

    def result(self, timeout: Optional[float] = None) -> SearchResult:
        if not self._event.wait(timeout):
            raise TimeoutError("search request timed out")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


class BatchingServer:
    def __init__(
        self,
        searcher,
        user_masks: np.ndarray,
        max_batch: int = 2048,
        max_wait_ms: float = 2.0,
    ):
        self._searcher = searcher
        self._user_masks = user_masks
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._q: "queue.Queue[Optional[SearchRequest]]" = queue.Queue()
        self._batch_sizes: List[int] = []
        self._served = 0
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="vsrbac-dispatch")
        self._thread.start()

    # ------------------------------------------------------------- client

    def submit(self, query: np.ndarray, user_id: int, k: int) -> SearchRequest:
        req = SearchRequest(query=np.asarray(query, dtype=np.float32),
                            user_id=int(user_id), k=int(k))
        # closed-check and enqueue under one lock: without it, a submit
        # that passes the check can enqueue AFTER close() drains leftovers
        # and its result() would hang forever
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._q.put(req)
        return req

    def search(self, query: np.ndarray, user_id: int, k: int,
               timeout: Optional[float] = None) -> SearchResult:
        """Blocking convenience wrapper: submit + wait."""
        return self.submit(query, user_id, k).result(timeout)

    # ----------------------------------------------------------- dispatch

    def _drain(self) -> List[SearchRequest]:
        """Block for the first request, then micro-batch stragglers."""
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            try:
                if remaining > 0:
                    nxt = self._q.get(timeout=remaining)
                else:  # window closed: take only what is already queued
                    nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is None:            # close sentinel: put it back for the
                self._q.put(None)      # outer loop, serve what we have
                break
            batch.append(nxt)
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._drain()
            if not batch:
                return
            by_k: Dict[int, List[SearchRequest]] = {}
            for r in batch:
                by_k.setdefault(r.k, []).append(r)
            for k, reqs in by_k.items():
                self._serve(reqs, k)
            self._account(len(batch))

    def _serve(self, reqs: List[SearchRequest], k: int) -> None:
        try:
            q = np.stack([r.query for r in reqs])
            uids = np.asarray([r.user_id for r in reqs])
            d, i = self._searcher.search_batch(q, uids, self._user_masks, k)
            now = time.perf_counter()
            for j, r in enumerate(reqs):
                r._result = SearchResult(
                    dists=np.asarray(d[j]), row_ids=np.asarray(i[j]),
                    latency_ms=(now - r.t_submit) * 1e3,
                    batch_size=len(reqs))
                r._event.set()
        except BaseException as e:  # propagate to every waiter
            for r in reqs:
                r._error = e
                r._event.set()

    def _account(self, batch_size: int) -> None:
        with self._lock:
            self._batch_sizes.append(batch_size)
            self._served += batch_size

    # ------------------------------------------------------------ control

    def stats(self) -> Dict[str, float]:
        with self._lock:
            bs = list(self._batch_sizes)
            served = self._served
        return {
            "served": served,
            "dispatches": len(bs),
            "avg_batch": float(np.mean(bs)) if bs else 0.0,
            "max_batch": int(np.max(bs)) if bs else 0,
        }

    def close(self) -> None:
        """Serve everything queued, then stop the dispatch thread. Submits
        enqueue under the lock that sets the close flag, so every request
        precedes the sentinel and the dispatch thread serves it."""
        with self._lock:
            self._closed = True
            self._q.put(None)
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def closed_loop(srv: BatchingServer, draw: Callable, k: int, clients: int,
                window_s: float, seed0: int = 0
                ) -> Tuple[Dict, List[Tuple[int, np.ndarray]]]:
    """Drive srv for window_s seconds with `clients` closed-loop threads:
    client i draws (query, user) = draw(rng) from default_rng(seed0 + i),
    submits it, waits for its answer and repeats until the window ends.
    Returns (report, served): the report holds the requests, the wall
    seconds from the first start to the last join (wall_s), QPS over that
    wall, p50/p95/p99 latency ms, the average batch and the dispatches;
    served is (user, row ids) for every answered request."""
    lat_ms: List[float] = []
    served: List[Tuple[int, np.ndarray]] = []
    lock = threading.Lock()
    stop = threading.Event()

    def client(seed):
        r = np.random.default_rng(seed)
        lat, got = [], []
        while not stop.is_set():
            q, u = draw(r)
            res = srv.search(q, u, k, timeout=120)
            lat.append(res.latency_ms)
            got.append((u, res.row_ids))
        with lock:
            lat_ms.extend(lat)
            served.extend(got)

    threads = [threading.Thread(target=client, args=(seed0 + i,))
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(window_s)
    stop.set()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    stats = srv.stats()
    lat = np.asarray(lat_ms) if lat_ms else np.zeros(1)
    report = {"requests": len(lat_ms), "wall_s": wall,
              "qps": len(lat_ms) / wall,
              "p50_ms": float(np.percentile(lat, 50)),
              "p95_ms": float(np.percentile(lat, 95)),
              "p99_ms": float(np.percentile(lat, 99)),
              "avg_batch": stats["avg_batch"],
              "dispatches": stats["dispatches"]}
    return report, served
