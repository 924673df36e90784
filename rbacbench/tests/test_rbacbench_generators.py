"""The frozen generators against the program's on small seeds: the tree
world equal to vectorsearch_rbac_tpu_torch.rbac's, array for array, and
the corpus laid out as the program's document grouping lays it out."""

import numpy as np
import pytest
import torch

from rbacbench.corpora import sift_like
from rbacbench.worlds import tree
from vectorsearch_rbac_tpu_torch.data.datasets import _group_into_documents
from vectorsearch_rbac_tpu_torch.rbac import TreeRBACGenerator


@pytest.mark.parametrize("args", [
    dict(num_users=500, num_roles=100, num_docs=1000, seed=7),
    dict(num_users=300, num_roles=300, num_docs=2000, seed=2**31 + 11),
    dict(num_users=97, num_roles=20, num_docs=150, seed=0),
])
def test_tree_world_matches_program(args):
    want = TreeRBACGenerator(h=4, b0=3, b1=4, **args).generate()
    got = tree.generate(h=4, b0=3, b1=4, **args)
    assert got.user_to_roles == dict(want.user_to_roles)
    assert got.role_to_docs == dict(want.role_to_docs)
    np.testing.assert_array_equal(got.user_masks, want.user_masks)
    np.testing.assert_array_equal(got.doc_role_bits, want.doc_role_bits)


@pytest.mark.parametrize("n", [3000, 3066])
def test_corpus_layout_and_values(n):
    spec = dict(num_vectors=n, dim=128, blocks_per_doc=100,
                query_pool=500)
    c = sift_like.make(spec, 2**31 + 3, torch.device("cpu"))
    assert c.rows.dtype == np.uint8 and c.rows.shape == (n, 128)
    assert c.pool.dtype == np.float32 and c.pool.shape == (500, 128)
    assert np.all(c.pool == np.floor(c.pool)) and c.pool.max() <= 255
    # the program's grouping of rows drawn in document order, the last
    # document short where the rows do not split evenly
    ref = _group_into_documents(np.zeros((n, 1), np.float32), 100)
    np.testing.assert_array_equal(c.doc_ids, ref.doc_ids)
    np.testing.assert_array_equal(c.block_ids, ref.block_ids)
    assert c.num_docs == int(ref.doc_ids.max()) + 1
    again = sift_like.make(spec, 2**31 + 3, torch.device("cpu"))
    np.testing.assert_array_equal(c.rows, again.rows)
    other = sift_like.make(spec, 2**31 + 4, torch.device("cpu"))
    assert not np.array_equal(c.rows, other.rows)
