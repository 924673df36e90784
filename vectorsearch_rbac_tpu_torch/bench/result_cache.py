"""Query-result cache.

A copy of vectorsearch_rbac_tpu/bench/result_cache.py `CachedSearcher`: an
LRU keyed by (the user's role combination, the query's bytes, k) around
any searcher. Users with the same roles share entries, the observation
behind the combination-role partition strategy. Within a batch a repeated
key is served from its first occurrence.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Tuple

import numpy as np

from ..rbac import RBACWorld


class CachedSearcher:
    def __init__(self, searcher, world: RBACWorld, capacity: int = 10000):
        self.inner = searcher
        self.world = world
        self.capacity = capacity
        self._cache: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    @property
    def name(self) -> str:
        return self.inner.name + "+cache"

    @property
    def arena(self):
        return self.inner.arena

    @property
    def partitions(self):
        return self.inner.partitions

    def storage_report(self):
        return self.inner.storage_report()

    def _key(self, uid: int, q: np.ndarray, k: int) -> bytes:
        comb = self.world.user_to_roles.get(uid, ())
        h = hashlib.blake2b(digest_size=16)
        h.update(np.ascontiguousarray(q, dtype=np.float32).tobytes())
        h.update(repr((comb, k)).encode())
        return h.digest()

    def search_batch(self, queries: np.ndarray, user_ids: np.ndarray,
                     user_masks: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, dtype=np.float32)
        user_ids = np.asarray(user_ids)
        nq = queries.shape[0]
        out_d = np.full((nq, k), np.inf)
        out_i = np.full((nq, k), -1, dtype=np.int64)
        miss_idx, keys, aliases = [], [], []
        first_of_key: dict = {}
        for qi in range(nq):
            key = self._key(int(user_ids[qi]), queries[qi], k)
            keys.append(key)
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                out_d[qi], out_i[qi] = hit
                self.hits += 1
            elif key in first_of_key:   # repeated within the batch
                aliases.append((qi, first_of_key[key]))
                self.hits += 1
            else:
                first_of_key[key] = qi
                miss_idx.append(qi)
                self.misses += 1
        if miss_idx:
            d, i = self.inner.search_batch(queries[miss_idx],
                                           user_ids[miss_idx], user_masks, k)
            for j, qi in enumerate(miss_idx):
                out_d[qi], out_i[qi] = d[j], i[j]
                self._cache[keys[qi]] = (d[j].copy(), i[j].copy())
                if len(self._cache) > self.capacity:
                    self._cache.popitem(last=False)
        for qi, src in aliases:
            out_d[qi], out_i[qi] = out_d[src], out_i[src]
        return out_d, out_i

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "entries": len(self._cache)}
