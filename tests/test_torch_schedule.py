"""The port's K(t) schedules and spec language against the reference's,
plus the reference's schedule property tests run on the port."""
import pytest
from hypothesis import given, settings, strategies as st

from repro.api import parse_schedule as jax_parse_schedule
from repro.core.schedule import group_size_phases as jax_group_size_phases
from repro_torch.api.schedules import parse_schedule, schedule_help
from repro_torch.core.schedule import (group_size_phases, step_schedule)

SPECS = ["step:300", "step:50", "linear:2000", "cosine:horizon=2000",
         "exp:horizon=2000,rate=5", "exp:500", "const:1", "const:4"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("workers", [5, 25])
def test_schedule_matches_reference(spec, workers):
    ours = parse_schedule(spec, workers)
    ref = jax_parse_schedule(spec, workers)
    assert ours.name == ref.name and ours.num_workers == ref.num_workers
    assert [ours(t) for t in range(2000)] == [ref(t) for t in range(2000)]
    assert ours.phases(2000) == ref.phases(2000)
    assert group_size_phases(ours, 2000, 16) == \
        jax_group_size_phases(ref, 2000, 16)


@pytest.mark.parametrize("bad", ["", "nope:3", "step:1,2", "step:x=1",
                                 "step:1,step_size=2"])
def test_bad_specs_rejected_like_reference(bad):
    with pytest.raises(ValueError):
        jax_parse_schedule(bad, 5)
    with pytest.raises(ValueError):
        parse_schedule(bad, 5)


def test_schedule_help_lists_every_family():
    text = schedule_help()
    for fam in ("step", "linear", "cosine", "exp", "const"):
        assert fam in text


# the reference's properties (tests/test_hybrid_core.py), on the port

@settings(max_examples=30, deadline=None)
@given(workers=st.integers(2, 64), kind=st.sampled_from(
    ["step", "linear", "cosine", "exp"]), horizon=st.integers(10, 2000),
    t=st.integers(0, 5000))
def test_schedule_monotone_and_bounded(workers, kind, horizon, t):
    arg = 50 if kind == "step" else horizon
    s = parse_schedule(f"{kind}:{arg}", workers)
    k_t, k_next = s(t), s(t + 1)
    assert 1 <= k_t <= workers
    assert k_next >= k_t


def test_step_schedule_matches_paper():
    s = step_schedule(25, 300)
    assert s(0) == 1 and s(299) == 1 and s(300) == 2 and s(599) == 2
    assert s(300 * 24) == 25 and s(10 ** 6) == 25


def test_schedule_phases():
    s = step_schedule(4, 10)
    assert s.phases(40) == [(0, 1), (10, 2), (20, 3), (30, 4)]
    sizes = [x[1] for x in group_size_phases(s, 40, axis_size=16)]
    assert sizes == sorted(sizes)
    assert all(16 % x == 0 for x in sizes)
    assert sizes[-1] == 16
