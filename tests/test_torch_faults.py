"""The port's fault plane against the JAX package on the CPU: the NDMP
transport seam, ``rejoin`` and the state export of ``core/ndmp.py``;
``faults/plan.py`` (``FaultPlan``, ``ChaosEngine`` over both NDMP
engines) and ``faults/degrade.py`` (``BackoffPolicy``,
``HealthTracker``, ``RepairPolicy``); the controller's bounded repair;
and ``SlotTrainLoop``'s degraded rounds (``health=``,
``faults_injected``) through the reference's ``fault_storm`` arms at
their quick sizes.  The same calls go to both packages; each tolerance
is stated where it is used."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro.core.ndmp import Simulator as JSimulator
from repro.obs import telemetry as j_telemetry
from repro.obs.rounds import RoundLedger as JRoundLedger
from repro.optim import optimizers as jopt
from repro.overlay import OverlayController as JController
from repro.runtime import SlotTrainLoop as JSlotTrainLoop
from repro.runtime import masked_local_step as j_masked_local_step
from repro.scale import VectorSimulator as JVectorSimulator
from repro_torch import faults
from repro_torch.core.mixing import masked_mixing_matrix
from repro_torch.core.ndmp import Simulator
from repro_torch.obs import telemetry
from repro_torch.obs.rounds import RoundLedger
from repro_torch.optim import optimizers as topt
from repro_torch.overlay import OverlayController
from repro_torch.runtime.loop import SlotTrainLoop
from repro_torch.runtime.masked import masked_local_step
from repro_torch.scale import VectorSimulator

KW = dict(num_spaces=2, latency=0.05, heartbeat_period=0.5, probe_period=1.0)


def _sim(cls, n, seed=0):
    sim = cls(seed=seed, **KW)
    sim.seed_network(list(range(n)))
    return sim


def _vec(cls, n):
    sim = cls(**KW)
    sim.seed_network(range(n))
    return sim


def _assert_same_tables(t, j):
    assert t.now == j.now
    assert t.alive_ids() == j.alive_ids()
    assert t.neighbor_tables() == j.neighbor_tables()
    assert t.tables_version() == j.tables_version()
    assert t.correctness() == j.correctness()


# --------------------------------------------------------------------------
# core/ndmp.py: the transport seam, rejoin, the state export
# --------------------------------------------------------------------------

def test_ndmp_filter_rejoin_and_export_match_reference():
    """A deterministic filter cuts the network in two (dropping every
    cross-side message) until failure detection prunes each side; then
    side B rejoins through side A.  After every window: the tables,
    stamps and correctness, the message counts, ``avg_messages_per_node``
    and ``export_state`` equal the reference's (exact)."""
    side = set(range(8))

    def cut(now, src, dst, msg):
        return (False, 0.0, 0) if (src in side) != (dst in side) else None

    def delay(now, src, dst, msg):
        return (True, 0.01, 1) if (src + dst) % 3 == 0 else None

    sims = [_sim(Simulator, 16), _sim(JSimulator, 16)]
    for sim in sims:
        sim.set_message_filter(cut)
    for t_end in (2.0, 6.0):
        for sim in sims:
            sim.run_until(t_end)
        _assert_same_tables(*sims)
    assert sims[0].correctness() < 1.0
    for sim in sims:
        sim.set_message_filter(delay)
        for u in range(8, 16):
            sim.rejoin(u, 0)
    for t_end in (6.5, 10.0, 30.0):
        for sim in sims:
            sim.run_until(t_end)
        _assert_same_tables(*sims)
    t, j = sims
    assert t.correctness() == 1.0
    assert (t.dropped_messages, t.delivered_messages) == \
        (j.dropped_messages, j.delivered_messages)
    for join_only in (False, True):
        assert t.avg_messages_per_node(join_only) == j.avg_messages_per_node(join_only)
    a, b = t.export_state(), j.export_state()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    t.fail(3)
    with pytest.raises(KeyError, match="not alive"):
        t.rejoin(3, 0)


# --------------------------------------------------------------------------
# faults/plan.py and faults/degrade.py
# --------------------------------------------------------------------------

def test_fault_plan_validation_matches_reference():
    for mod in (faults, jfaults):
        with pytest.raises(ValueError, match="msg_loss"):
            mod.FaultPlan(msg_loss=1.0)
        with pytest.raises(ValueError, match="msg_dup"):
            mod.FaultPlan(msg_dup=-0.1)
        with pytest.raises(ValueError, match="after start"):
            mod.Partition(5.0, 5.0, ((0,), (1,)))
        with pytest.raises(ValueError, match=">= 2 groups"):
            mod.Partition(0.0, 1.0, ((0, 1),))
        with pytest.raises(ValueError, match="overlap"):
            mod.Partition(0.0, 1.0, ((0, 1), (1, 2)))
    p = faults.Partition(0.0, 1.0, ((0, 1), (2, 3)))
    assert p.group_of(2) == 1 and p.group_of(9) is None
    for kw in ({}, dict(msg_loss=0.1), dict(msg_loss=0.2, msg_delay=0.3, delay_factor=2.0),
               dict(msg_dup=0.1)):
        tp, jp = faults.FaultPlan(**kw), jfaults.FaultPlan(**kw)
        assert tp.message_faults == jp.message_faults
        assert tp.delay_scale() == jp.delay_scale()


@pytest.mark.parametrize("seed,base,cap", [(0, 0.5, 8.0), (3, 0.25, 2.0), (11, 1.0, 1.0)])
def test_backoff_sequences_match_reference(seed, base, cap):
    t, j = faults.BackoffPolicy(base, cap, seed), jfaults.BackoffPolicy(base, cap, seed)
    seq = [t.next_delay() for _ in range(12)]
    assert seq == [j.next_delay() for _ in range(12)]
    t.reset()
    assert t.next_delay() == seq[0]
    for bad in (dict(base=0.0), dict(base=2.0, cap=1.0)):
        with pytest.raises(ValueError):
            faults.BackoffPolicy(**bad)


HEALTH_OPS = [("suspect", 7, 10.0), ("suspect", 7, 10.5), ("poll", 11.0),
              ("suspect", 3, 11.0), ("poll", 12.0), ("heal", 7, "stale", 12.5),
              ("heal", 3, "now", 12.6), ("heal", 7, "now", 13.0), ("poll", 14.0),
              ("heal", 7, "now", 14.0), ("suspect", 7, 15.0), ("poll", 17.5)]


def test_health_tracker_sequence_matches_reference():
    """The versioned lifecycle, op by op: every return value, state,
    version and the unhealthy / evicted sets, and the ``faults.*``
    counters on each package's bus, equal."""
    outs = []
    for mod, bus_ctx in ((faults, telemetry), (jfaults, j_telemetry)):
        h, seen, stale = mod.HealthTracker(suspect_grace=2.0), [], {}
        with bus_ctx() as bus:
            for op in HEALTH_OPS:
                if op[0] == "suspect":
                    stale[op[1]] = h.suspect(op[1], op[2])
                    seen.append(stale[op[1]])
                elif op[0] == "poll":
                    h.poll(op[1])
                else:
                    v = stale[op[1]] if op[2] == "stale" else h.version_of(op[1])
                    seen.append(h.heal(op[1], v, op[3]))
                seen.append(tuple((u, h.state_of(u).value, h.version_of(u)) for u in (3, 7)))
                seen.append((h.unhealthy(), h.evicted()))
            counters = {k: v for k, v in bus.counters.items() if k.startswith("faults.")}
        outs.append((seen, counters))
    assert outs[0] == outs[1]
    assert outs[0][1]["faults.evictions"] >= 2


def test_controller_repair_retry_matches_reference():
    """After a failure inside a window too short for detection, the
    bounded wait-for-repair retries under the same backoff draws and
    recovers at the same simulated time; a stuck overlay gives up after
    ``max_retries``."""
    ctls = []
    for Sim, Ctl, mod in ((Simulator, OverlayController, faults),
                          (JSimulator, JController, jfaults)):
        sim = _sim(Sim, 6)
        ctl = Ctl(sim, capacity=8, repair_policy=mod.RepairPolicy())
        sim.fail(2)
        ctl.step(0.2)
        ctls.append(ctl)
    t, j = ctls
    assert t.sim.correctness() == 1.0 and t.repair_retries >= 1
    assert (t.repair_retries, t.repair_recovered, t.repair_gave_up) == \
        (j.repair_retries, j.repair_recovered, j.repair_gave_up)
    _assert_same_tables(t.sim, j.sim)
    assert t.alive == j.alive

    class _Stuck:
        now = 0.0

        def correctness(self):
            return 0.5

        def run_until(self, t):
            self.now = t

    with telemetry() as bus:
        ctl = OverlayController(_sim(Simulator, 6), capacity=8,
                                repair_policy=faults.RepairPolicy(max_retries=3))
        ctl.sim = _Stuck()
        assert not ctl._repair_retry()
    assert (ctl.repair_retries, ctl.repair_gave_up, ctl.repair_recovered) == (3, 1, 0)
    assert bus.counters["faults.repair_retries"] == 3
    assert bus.counters["faults.repair_gave_up"] == 1


def test_chaos_engine_events_and_data_faults_match_reference():
    """Crash guard, a fresh rejoin, link outage / straggler / partition
    windows: the counts, the tables and every ``data_faults`` snapshot
    equal the reference's; the asymmetric partition blocks one way."""
    kw = dict(crashes=((1.0, 3), (2.0, 3)), rejoins=((5.0, 3, 0),))
    engines = []
    for mod, Sim in ((faults, Simulator), (jfaults, JSimulator)):
        plan = mod.FaultPlan(
            link_outages=(mod.LinkOutage(1.0, 3.0, a=4, b=2),),
            stragglers=(mod.Straggler(2.0, 5.0, node=1),),
            partitions=(mod.Partition(6.0, 8.0, ((0, 1, 2), (3, 4, 5))),), **kw)
        engines.append(mod.ChaosEngine(_sim(Sim, 8), plan))
    t, j = engines
    for t_end in (0.0, 1.5, 2.5, 3.5, 6.5, 8.5, 20.0, 40.0):
        for e in engines:
            e.run_until(t_end)
        assert t.counts == j.counts
        a, b = t.data_faults(), j.data_faults()
        assert (a.down_pairs, a.slow_nodes, a.groups) == (b.down_pairs, b.slow_nodes, b.groups)
        _assert_same_tables(t, j)
    assert t.counts["crashes"] == 1 and t.counts["rejoins"] >= 1
    assert 3 in t.alive_ids() and t.correctness() == 1.0
    p = faults.Partition(1.0, 2.0, ((0, 1), (2, 3)), symmetric=False)
    t._active = [p]
    assert t._blocked(0, 2) and not t._blocked(2, 0) and not t._blocked(0, 1)


def _storm_plan(mod, n, loss, partition, stragglers):
    """The reference benchmark's storm (``benchmarks/fault_storm.py``)."""
    parts = ()
    if partition:
        half = tuple(range(n // 2)), tuple(range(n // 2, n))
        parts = (mod.Partition(start=2.0, end=14.0, groups=half),)
    slow = tuple(mod.Straggler(start=2.0, end=18.0, node=n - 1 - i)
                 for i in range(stragglers))
    return mod.FaultPlan(seed=7, msg_loss=loss, partitions=parts, stragglers=slow)


STORM_ARMS = {"clean": (0.0, False, 0), "loss": (0.10, False, 0),
              "loss+straggle": (0.10, False, 2),
              "loss+partition+straggle": (0.10, True, 2)}


@pytest.mark.parametrize("engine", ["object", "vector"])
def test_chaos_engine_storm_matches_reference(engine):
    """The storm of the benchmark's partition arm (10 % loss, the 2-way
    partition over [2, 14), 2 stragglers), n 12, on each engine: counts
    and tables equal to the reference's after every second; then the
    port's object and vector engines hold identical tables once healed
    and settled."""
    n = 12
    pair = []
    for mod, Sim, Vec in ((faults, Simulator, VectorSimulator),
                          (jfaults, JSimulator, JVectorSimulator)):
        sim = _sim(Sim, n) if engine == "object" else _vec(Vec, n)
        pair.append(mod.ChaosEngine(sim, _storm_plan(mod, n, 0.10, True, 2)))
    t, j = pair
    for t_end in np.arange(1.0, 46.0, 1.0):
        for e in pair:
            e.run_until(float(t_end))
        assert t.counts == j.counts
        _assert_same_tables(t, j)
    assert t.counts["partition_heals"] == 1 and t.correctness() == 1.0
    if engine == "object":
        assert t.counts["msg_dropped"] > 0 and t.counts["rejoins"] >= 1
        other = faults.ChaosEngine(_vec(VectorSimulator, n),
                                   _storm_plan(faults, n, 0.10, True, 2))
        other.run_until(45.0)
        assert other.neighbor_tables() == t.neighbor_tables()
        for k in ("ids", "succ", "pred"):
            np.testing.assert_array_equal(other.export_state()[k], t.export_state()[k])


# --------------------------------------------------------------------------
# SlotTrainLoop under the storm (the fault_storm benchmark's quick arms)
# --------------------------------------------------------------------------

DIM = 64
TARGET_SPREAD = 1e-3


def _init(u):
    return np.random.default_rng(u).normal(size=DIM).astype(np.float32)


def _j_step(params, opt_state, batch):
    return params, opt_state, {"loss": jnp.mean(params["w"] ** 2, axis=-1)}


def _t_step(params, opt_state, batch):
    return params, opt_state, {"loss": (params["w"] ** 2).mean(dim=-1)}


def _recording(cls):
    """``cls`` with every round's edge mask kept in ``masks``."""
    class Recording(cls):
        def _edge_mask(self, now):
            em, degraded = super()._edge_mask(now)
            self.masks = getattr(self, "masks", []) + [np.array(em)]
            return em, degraded
    return Recording


def _storm_loops(arm, health):
    """The arm on both packages: n 8, capacity 8, an identity local step
    (only mixing moves the rows), each loop with its ledger; the port's
    loop keeps its population resident flat, and both mix the flat
    ``gather_mix`` round."""
    loss, part, slow = STORM_ARMS[arm]
    j_sim = jfaults.ChaosEngine(_sim(JSimulator, 8), _storm_plan(jfaults, 8, loss, part, slow))
    t_sim = faults.ChaosEngine(_sim(Simulator, 8), _storm_plan(faults, 8, loss, part, slow))
    jl, tl = JRoundLedger(), RoundLedger()
    jloop = _recording(JSlotTrainLoop)(
        JController(j_sim, capacity=8, fuse="flat", flat_io=True),
        local_step=j_masked_local_step(_j_step),
        make_params=lambda u: {"w": jnp.asarray(_init(u))}, optimizer=jopt.sgd(0.0),
        make_batch=lambda ids, s: {"x": jnp.zeros((len(ids), 1), jnp.float32)},
        ledger=jl, health=jfaults.HealthTracker(1.0) if health else None)
    tloop = _recording(SlotTrainLoop)(
        OverlayController(t_sim, capacity=8, fuse="flat", flat_io=True),
        local_step=masked_local_step(_t_step),
        make_params=lambda u: {"w": torch.from_numpy(_init(u))}, optimizer=topt.sgd(0.0),
        make_batch=lambda ids, s: {"x": torch.zeros((len(ids), 1))},
        ledger=tl, health=faults.HealthTracker(1.0) if health else None)
    return (jloop, jl), (tloop, tl)


def _jw(loop):
    """The reference loop's (capacity, DIM) rows of its resident flat
    buffer."""
    return np.asarray(loop._spec.unravel(loop.params)["w"])


def _spread(rows):
    return float(np.abs(rows - rows.mean(axis=0)).max())


@pytest.mark.parametrize("arm", sorted(STORM_ARMS))
def test_storm_arm_slot_loop_matches_reference(arm):
    """Round by round until consensus (spread < 1e-3, at most 120
    rounds): the same tables and counts, every round's edge mask equal,
    the same ``faults_injected`` and ``degraded_edges`` in the ledgers, the population within 1e-6 x
    max|p| (f32 sums in another order), the same rounds to target, and
    the resident buffers never reallocated.  The partition arm also
    carries a HealthTracker that suspects node 0 at round 3 (evicted
    after 1 s, healed at round 9)."""
    health = "partition" in arm
    (jloop, jl), (tloop, tl) = _storm_loops(arm, health)
    ptrs = {tloop.params.data_ptr(), tloop._spare.data_ptr()}
    rounds = {}
    for r in range(120):
        for loop in (jloop, tloop):
            if health and r == 3:
                loop.health.suspect(0, loop.controller.sim.now)
            if health and r == 9:
                assert loop.health.heal(0, loop.health.version_of(0))
        jloop.run(1)
        tloop.run(1)
        _assert_same_tables(tloop.controller.sim, jloop.controller.sim)
        assert tloop.controller.sim.counts == jloop.controller.sim.counts
        jw = _jw(jloop)
        tw = tloop.state.tree()["w"].numpy()
        np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6 * np.abs(jw).max())
        for name, loop, w in (("j", jloop, jw), ("t", tloop, tw)):
            slots = [loop.controller.slots.slot_of[u] for u in loop.controller.alive]
            if name not in rounds and _spread(w[slots]) < TARGET_SPREAD:
                rounds[name] = r + 1
        if len(rounds) == 2:
            break
    assert rounds["t"] == rounds["j"]
    assert len(tloop.masks) == len(jloop.masks) == len(tl.rows)
    for a, b in zip(tloop.masks, jloop.masks):
        np.testing.assert_array_equal(a, b)
    keys = ("faults_injected", "degraded_edges")
    assert [tuple(r.extra[k] for k in keys) for r in tl.rows] == \
        [tuple(getattr(r, k) for k in keys) for r in jl.rows]
    assert sum(r.extra["faults_injected"] for r in tl.rows) == \
        sum(tloop.controller.sim.counts.values())
    assert (sum(r.extra["degraded_edges"] for r in tl.rows) > 0) == \
        (STORM_ARMS[arm][2] > 0)
    assert {tloop.params.data_ptr(), tloop._spare.data_ptr()} == ptrs


def test_degraded_rounds_equal_dense_oracle_on_one_cache_entry():
    """Stragglers on: each round's rows equal the dense renormalized
    oracle (``masked_mixing_matrix`` with the edge mask) within 1e-6, a
    straggler keeps its own row, and no round adds a cache entry."""
    plan = faults.FaultPlan(stragglers=tuple(faults.Straggler(0.0, 1e9, u) for u in (4, 5)))
    chaos = faults.ChaosEngine(_sim(Simulator, 6), plan)
    loop = SlotTrainLoop(
        OverlayController(chaos, capacity=8, fuse="flat", flat_io=True),
        local_step=masked_local_step(_t_step),
        make_params=lambda u: {"w": torch.from_numpy(_init(u))}, optimizer=topt.sgd(0.0),
        make_batch=lambda ids, s: {"x": torch.zeros((len(ids), 1))})
    ctl = loop.controller
    loop.run(1)
    misses = ctl.cache.misses
    for _ in range(3):
        X = loop.state.tree()["w"].numpy().copy()
        mask = ctl.alive_mask()
        em = faults.edge_mask_for(ctl.schedule, [ctl.slots.node_at(s) for s in range(8)],
                                  chaos.data_faults())
        assert (em == 0.0).any()
        loop.run(1)
        got = loop.state.tree()["w"].numpy()
        np.testing.assert_allclose(got, masked_mixing_matrix(ctl.schedule, mask, em) @ X,
                                   rtol=0, atol=1e-6)
        for u in (4, 5):
            s = ctl.slots.slot_of[u]
            np.testing.assert_allclose(got[s], X[s], rtol=0, atol=1e-6)
    assert ctl.cache.misses == misses


def test_health_alone_feeds_the_edge_mask_like_reference():
    """Without a chaos engine, an evicted node's edges drop from the
    loop's mask, as in the reference; the two masks are equal."""
    loops = []
    for Sim, Ctl, Loop, mod, step, mk in (
            (Simulator, OverlayController, SlotTrainLoop, faults, masked_local_step(_t_step),
             lambda u: {"w": torch.from_numpy(_init(u))}),
            (JSimulator, JController, JSlotTrainLoop, jfaults, j_masked_local_step(_j_step),
             lambda u: {"w": jnp.asarray(_init(u))})):
        zeros = torch.zeros if Loop is SlotTrainLoop else \
            (lambda shape: jnp.zeros(shape, jnp.float32))
        loop = Loop(Ctl(_sim(Sim, 6), capacity=8, fuse="flat", flat_io=True),
                    local_step=step, make_params=mk,
                    optimizer=(topt if Loop is SlotTrainLoop else jopt).sgd(0.0),
                    make_batch=lambda ids, s, z=zeros: {"x": z((len(ids), 1))},
                    health=mod.HealthTracker(suspect_grace=0.0))
        loop.health.suspect(2, now=0.0)
        loop.run(1)
        loops.append(loop)
    t, j = loops
    em_t, deg_t = t._edge_mask(t.controller.sim.now)
    em_j, deg_j = j._edge_mask(j.controller.sim.now)
    np.testing.assert_array_equal(em_t, em_j)
    assert deg_t == deg_j > 0
    np.testing.assert_allclose(t.state.tree()["w"].numpy(), _jw(j), rtol=0,
                               atol=1e-6 * float(np.abs(_jw(j)).max()))


def test_fault_counters_land_on_the_bus_and_ledger():
    plan = faults.FaultPlan(seed=2, msg_loss=0.15, stragglers=(faults.Straggler(0.0, 1e9, 3),))
    ledger = RoundLedger()
    with telemetry() as bus:
        chaos = faults.ChaosEngine(_sim(Simulator, 6), plan)
        loop = SlotTrainLoop(
            OverlayController(chaos, capacity=8, fuse="flat", flat_io=True),
            local_step=masked_local_step(_t_step),
            make_params=lambda u: {"w": torch.from_numpy(_init(u))},
            optimizer=topt.sgd(0.0),
            make_batch=lambda ids, s: {"x": torch.zeros((len(ids), 1))}, ledger=ledger)
        loop.run(4)
    assert bus.counters.get("faults.msg_dropped", 0) == chaos.counts["msg_dropped"] > 0
    assert sum(r.extra["faults_injected"] for r in ledger.rows) == sum(chaos.counts.values())
    assert all(r.extra["degraded_edges"] > 0 for r in ledger.rows)
