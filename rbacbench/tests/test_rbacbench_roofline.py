"""The least time of a call on a hand-worked shape."""

import pytest

from rbacbench import roofline


def test_hand_worked_shape():
    # 1,000 rows of d 128 in 10 documents with 4 bitset words, 10
    # queries, k 5, 2,500 readable pairs: bytes 1,000 * 128 + 10 * 16 +
    # 10 * 128 + 10 * 5 * 4 = 129,640; operations 2 * 128 * 2,500 =
    # 640,000
    nbytes, ops = roofline.filtered_search_work(1000, 10, 128, 4, 10, 5,
                                                2500)
    assert nbytes == 129_640 and ops == 640_000
    bw, top = roofline.peaks("NVIDIA H100 80GB HBM3")
    t, by = roofline.bound_s(nbytes, ops, bw, top)
    assert by == "bytes" and t == pytest.approx(129_640 / 3.35e12)
    t, by = roofline.bound_s(1.0, 1e9, bw, top)
    assert by == "operations" and t == pytest.approx(1e9 / 1.979e15)


def test_unknown_card_has_no_peaks():
    assert roofline.peaks("cpu") is None
