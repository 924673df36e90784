"""The port's RBAC generators against the JAX reference's on the CPU: the
tree, sharing-tree, ERBAC, random and arXiv business-role generators
(rbac.GENERATORS) give the reference's world for the same seed and
parameters (user roles, role documents, user masks, document bitsets,
combinations), and synthetic_categories the same labels."""

import numpy as np
import pytest

from vectorsearch_rbac_tpu.rbac.generators import GENERATORS as REF
from vectorsearch_rbac_tpu.rbac.generators.arxiv_business import (
    synthetic_categories as ref_categories)
from vectorsearch_rbac_tpu_torch.rbac import (GENERATORS, RBACGenerator,
                                              synthetic_categories)

CASES = {
    "tree": dict(num_users=120, num_roles=24, num_docs=300, seed=3),
    "sharing_tree": dict(num_users=120, num_roles=24, num_docs=300, seed=3),
    "sharing_tree-heavy": dict(num_users=90, num_roles=16, num_docs=200,
                               doc_sharing_distribution=(80, 5, 2, 6),
                               seed=1),
    "erbac": dict(num_users=150, n_froles=20, n_broles=12, num_docs=300,
                  m_perms=40, seed=3),
    "erbac-tight": dict(num_users=60, n_froles=10, n_broles=8, num_docs=100,
                        m_perms=10, m_froles=2, seed=8),
    "random": dict(num_users=150, num_roles=20, num_docs=300, m_perms=40,
                   seed=3),
    "random-tight": dict(num_users=50, num_roles=10, num_docs=100,
                         m_roles=2, m_perms=10, seed=2),
    "arxiv_business": dict(num_users=150, num_docs=300, num_categories=12,
                           n_broles=15, seed=3),
    "arxiv_business-given": dict(
        num_users=40, num_docs=50, n_broles=6,
        doc_categories={d: d % 7 for d in range(50)}, seed=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generator_world_matches_reference(case):
    name = case.split("-")[0]
    kw = CASES[case]
    gen = GENERATORS[name](**kw)
    assert isinstance(gen, RBACGenerator)
    got, want = gen.generate(), REF[name](**kw).generate()
    assert (got.num_users, got.num_roles, got.num_docs) == (
        want.num_users, want.num_roles, want.num_docs)
    assert dict(got.user_to_roles) == dict(want.user_to_roles)
    assert dict(got.role_to_docs) == dict(want.role_to_docs)
    np.testing.assert_array_equal(got.user_masks, want.user_masks)
    np.testing.assert_array_equal(got.doc_role_bits, want.doc_role_bits)
    assert got.combs == want.combs
    assert got.comb_weights == want.comb_weights


def test_registry_and_categories_match_reference():
    assert sorted(GENERATORS) == sorted(REF)
    for seed, (n, c, a) in enumerate([(500, 7, 1.5), (64, 40, 2.0)]):
        np.testing.assert_array_equal(synthetic_categories(n, c, seed, a),
                                      ref_categories(n, c, seed, a))


@pytest.mark.parametrize("name,kw", [
    ("random", dict(num_roles=2, num_docs=100, m_perms=10)),
    ("erbac", dict(n_froles=2, num_docs=100, m_perms=10)),
])
def test_generators_refuse_uncoverable_worlds(name, kw):
    with pytest.raises(ValueError):
        GENERATORS[name](**kw)
    with pytest.raises(ValueError):
        REF[name](**kw)
