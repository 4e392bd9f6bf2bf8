"""The port's copies of the host control plane against the reference on
the same calls: the NDMP simulator's tables under churn, the FedLay
schedules (perms and weights equal), the capacity-mode overlay
controller's schedules, remap plans and cache accounting over a scripted
churn trace, joiner donors, and the data-fault edge mask."""

import numpy as np
import pytest
import torch

from repro.core import mixing as jmix
from repro.core.mep import ClientProfile as JClientProfile
from repro.core.ndmp import Simulator as JSimulator
from repro.faults.plan import DataFaults as JDataFaults
from repro.faults.plan import edge_mask_for as j_edge_mask_for
from repro.overlay.controller import OverlayController as JController
from repro.overlay.events import ChurnTrace as JChurnTrace
from repro.overlay.runtime import joiner_donors as j_joiner_donors
from repro_torch.core import mixing
from repro_torch.core.mep import ClientProfile
from repro_torch.core.ndmp import Simulator, SimulatorProtocol
from repro_torch.faults.plan import DataFaults, edge_mask_for
from repro_torch.overlay.controller import OverlayController
from repro_torch.overlay.events import ChurnTrace
from repro_torch.overlay.runtime import joiner_donors

CHURN = [(1.5, "fail", 2), (2.5, "join", 40, 0), (3.5, "leave", 5),
         (4.2, "join", 41), (4.4, "join", 42, 1), (6.5, "fail", 0)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep each xdist worker's intra-op pool small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _sim(cls, n=8, L=2, seed=0):
    sim = cls(num_spaces=L, latency=0.05, heartbeat_period=0.5,
              probe_period=1.0, seed=seed)
    sim.seed_network(list(range(n)))
    return sim


def _same_schedule(a, b):
    assert (a.num_clients, a.num_spaces) == (b.num_clients, b.num_spaces)
    assert a.perms == b.perms
    np.testing.assert_array_equal(a.weights, b.weights)
    np.testing.assert_array_equal(a.self_weight, b.self_weight)
    assert a.digest() == b.digest()


def test_simulator_tables_match_under_churn():
    """The same seed and churn give the same neighbor tables, version
    stamps, clocks and correctness, window by window."""
    sim, jsim = _sim(Simulator), _sim(JSimulator)
    assert isinstance(sim, SimulatorProtocol)
    trace, jtrace = ChurnTrace.scripted(CHURN), JChurnTrace.scripted(CHURN)
    for t in np.arange(1.0, 9.0, 0.5):
        ChurnTrace.apply(sim, trace.between(t - 0.5, t))
        JChurnTrace.apply(jsim, jtrace.between(t - 0.5, t))
        sim.run_until(t)
        jsim.run_until(t)
        assert sim.neighbor_tables() == jsim.neighbor_tables()
        assert sim.tables_version() == jsim.tables_version()
        assert sim.now == jsim.now and sim.correctness() == jsim.correctness()
    assert sim.delivered_messages == jsim.delivered_messages


@pytest.mark.parametrize("n,L,salt", [(1, 2, ""), (2, 1, ""), (7, 2, ""),
                                      (16, 3, "s"), (33, 4, "")])
def test_build_permute_schedule_matches(n, L, salt):
    _same_schedule(mixing.build_permute_schedule(n, L, salt=salt),
                   jmix.build_permute_schedule(n, L, salt=salt))


def test_confidence_weighted_schedule_and_padding_match():
    rng = np.random.default_rng(0)
    hists = {i: rng.integers(1, 9, 5) for i in range(6)}
    periods = {i: float(rng.choice([0.5, 1.0, 2.0])) for i in range(6)}
    prof = {i: ClientProfile(i, periods[i], hists[i]) for i in range(6)}
    jprof = {i: JClientProfile(i, periods[i], hists[i]) for i in range(6)}
    for cw in (True, False):
        s = mixing.build_permute_schedule(6, 2, profiles=prof, confidence_weighted=cw)
        j = jmix.build_permute_schedule(6, 2, profiles=jprof, confidence_weighted=cw)
        _same_schedule(s, j)
        slots = [7, 0, 3, 1, 5, 2]
        _same_schedule(mixing.pad_schedule(s, slots, 9), jmix.pad_schedule(j, slots, 9))
    np.testing.assert_array_equal(
        mixing.multirate_participation([1.0, 2.0, 3.0, 1.0], 4),
        jmix.multirate_participation([1.0, 2.0, 3.0, 1.0], 4))


@pytest.mark.parametrize("double_buffered", [False, True])
def test_capacity_controller_matches_over_a_churn_trace(double_buffered):
    """Step by step: the same alive set, padded schedule, remap plan,
    swap / rebuild / cache-hit flags and cache counts."""
    kw = dict(capacity=10, double_buffered=double_buffered)
    ctl = OverlayController(_sim(Simulator), fuse="flat", flat_io=True, **kw)
    jctl = JController(_sim(JSimulator), fuse="flat", flat_io=True, **kw)
    trace, jtrace = ChurnTrace.scripted(CHURN), JChurnTrace.scripted(CHURN)
    for _ in range(9):
        r, jr = ctl.step(1.0, trace=trace), jctl.step(1.0, trace=jtrace)
        plan, jplan = ctl.commit(), jctl.commit()
        assert (r.alive, r.swapped, r.rebuilt, r.cache_hit, r.epoch, r.time) == (
            jr.alive, jr.swapped, jr.rebuilt, jr.cache_hit, jr.epoch, jr.time)
        assert (r.delta.joined, r.delta.left) == (jr.delta.joined, jr.delta.left)
        if jplan is None:
            assert plan is None
        else:
            assert (plan.survivors, plan.joiners, plan.leavers) == (
                jplan.survivors, jplan.joiners, jplan.leavers)
        assert ctl.alive == jctl.alive
        _same_schedule(ctl.schedule, jctl.schedule)
        _same_schedule(ctl.alive_schedule, jctl.alive_schedule)
        np.testing.assert_array_equal(ctl.alive_mask(), jctl.alive_mask())
    assert (ctl.cache.hits, ctl.cache.misses, ctl.rebuilds, ctl.swaps) == (
        jctl.cache.hits, jctl.cache.misses, jctl.rebuilds, jctl.swaps)


def test_joiner_donors_and_edge_mask_match():
    ctl = OverlayController(_sim(Simulator, n=9), capacity=12)
    jctl = JController(_sim(JSimulator, n=9), capacity=12)
    alive, sched, jsched = ctl.alive, ctl.alive_schedule, jctl.alive_schedule
    joiners, survivors = alive[::3], tuple(u for u in alive if u % 3)
    assert joiner_donors(sched, alive, joiners, survivors) == \
        j_joiner_donors(jsched, alive, joiners, survivors)
    slot_nodes = [ctl.slots.node_at(s) for s in range(12)]
    faults = dict(down_pairs=frozenset({(0, 4), (2, 7)}), slow_nodes=frozenset({5}),
                  groups=((0, 1, 2, 3), (4, 5, 6, 7, 8)))
    for kw in ({}, faults, {"slow_nodes": frozenset({1})}):
        np.testing.assert_array_equal(
            edge_mask_for(ctl.schedule, slot_nodes, DataFaults(**kw)),
            j_edge_mask_for(jctl.schedule, slot_nodes, JDataFaults(**kw)))


def test_controller_rejects_codecs_and_flat_io_without_flat():
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        OverlayController(_sim(Simulator, n=3), codec="bf16")
    with pytest.raises(ValueError, match="flat_io"):
        OverlayController(_sim(Simulator, n=3), capacity=4, flat_io=True)
