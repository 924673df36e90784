"""The plain reference against a brute-force numpy filter on a tiny
world, exact and at the control's codes; a metric without a file is
refused."""

import numpy as np
import pytest
import torch

from rbacbench import reference
from rbacbench.manifest import ManifestError
from rbacbench.worlds import tree


def _brute(rows, doc_of_row, doc_bits, masks, queries, kk, int4):
    x = rows.astype(np.int64)
    q = queries.astype(np.int64)
    if int4:
        x, q = x // 16, q // 16
    d_all, readable = [], []
    for qi in range(len(q)):
        can = (doc_bits[doc_of_row] & masks[qi][None, :]).any(axis=1)
        d = ((x - q[qi][None, :]) ** 2).sum(axis=1).astype(np.float64)
        d[~can] = np.inf
        d_all.append(d)
        readable.append(int(can.sum()))
    return np.stack(d_all), np.array(readable)


def test_filtered_topk_matches_brute_force():
    rng = np.random.default_rng(5)
    w = tree.generate(num_users=60, num_roles=12, num_docs=40, h=3, b0=2,
                      b1=3, seed=9)
    n = 4000
    rows = rng.integers(0, 256, size=(n, 16)).astype(np.uint8)
    doc_of_row = (np.arange(n) % w.num_docs).astype(np.int64)
    users = rng.integers(0, w.num_users, size=50)
    queries = rng.integers(0, 256, size=(50, 16)).astype(np.float32)
    masks = w.user_masks[users]
    kk = 30
    for control in (None, "int4"):
        d, i, readable = reference.filtered_topk(
            torch.from_numpy(rows), torch.from_numpy(doc_of_row),
            torch.from_numpy(w.doc_role_bits.view(np.int32)), masks,
            queries, kk, "l2", control=control)
        full, want_readable = _brute(rows, doc_of_row, w.doc_role_bits,
                                     masks, queries, kk,
                                     control == "int4")
        np.testing.assert_array_equal(readable, want_readable)
        want = np.sort(full, axis=1)[:, :kk]
        np.testing.assert_array_equal(d, want.astype(np.float32))
        # each returned row is readable and sits at its distance
        got = np.take_along_axis(full, np.maximum(i, 0), axis=1)
        np.testing.assert_array_equal(
            np.where(i >= 0, got, np.inf).astype(np.float32), d)


def test_exact_distances_are_integer_squared_l2():
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 256, size=(100, 128)).astype(np.uint8)
    q = rng.integers(0, 256, size=(3, 128)).astype(np.float32)
    ids = rng.integers(0, 100, size=(3, 7))
    d = reference.metric("l2").exact(torch.from_numpy(rows),
                                     torch.from_numpy(q),
                                     torch.from_numpy(ids)).numpy()
    want = ((rows[ids].astype(np.int64)
             - q[:, None, :].astype(np.int64)) ** 2).sum(axis=2)
    np.testing.assert_array_equal(d, want.astype(np.float32))


def test_a_metric_without_a_file_is_refused():
    rows = torch.zeros((4, 2), dtype=torch.uint8)
    bits = torch.ones((1, 1), dtype=torch.int32)
    with pytest.raises(ManifestError, match="cosine"):
        reference.filtered_topk(rows, torch.zeros(4, dtype=torch.int64),
                                bits, np.ones((1, 1), np.uint32),
                                np.zeros((1, 2), np.float32), 2, "cosine")
