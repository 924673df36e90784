"""The check at a size the CPU holds: a sound run comes out correct; the
control (the reference at int4 in the program's place) and each fault the
cell can have, planted under the timed path, come out not correct under
the cell's own limits. One chip: there is no exchange between chips to
leave out."""

import pytest

from tiny_cell import run_tiny, tiny_cell


def stale(search):
    """A call that returns the last call's answer unchanged."""
    last = {}

    def f(q, users, k):
        if "out" not in last:
            last["out"] = search(q, users, k)
        return last["out"]
    return f


def half(search):
    """Half of the batch left out."""
    def f(q, users, k):
        d, i = search(q, users, k)
        i = i.copy()
        i[len(i) // 2:] = -1
        return d, i
    return f


def altered(search):
    """One answer of every call altered where it is produced."""
    def f(q, users, k):
        d, i = search(q, users, k)
        i = i.copy()
        i[7, 3] = (i[7, 3] + 12_345) % 40_000
        return d, i
    return f


FAULTS = {"stale": stale, "half": half, "altered": altered}


@pytest.mark.parametrize("seed", [2**31 + 77, 2**32 + 5])
def test_sound_run_is_correct_and_control_is_not(seed):
    line = run_tiny(tiny_cell(), seed=seed, control=True)
    assert line["correct"] is True
    limits = {n: c["limit"] for n, c in line["checks"].items()}
    ctl = line["control"]
    assert any(ctl[n] > limits[n] for n in limits), ctl


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    line = run_tiny(tiny_cell(), wrap_search=FAULTS[fault])
    assert line["correct"] is False, line["checks"]
