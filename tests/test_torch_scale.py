"""The port's population-scale overlay against the JAX package on the CPU:
the batch coordinate hasher and the ring helpers of ``core/coords.py``,
the vectorized NDMP engine (``scale/ndmp_vec.py``) on fixed churn,
partition and rejoin traces, and cohort streaming (``scale/cohort.py``)
at the reference benchmark's quick sizes.  The same calls go to both
packages; each tolerance is stated where it is used.  The traces are
fixed cases, not a random search, so that no case here is unsteady."""

import numpy as np
import pytest
import torch

from repro.core import coords as jcoords
from repro.core.ndmp import Simulator as JSimulator
from repro.scale import CohortSampler as JCohortSampler
from repro.scale import CohortStreamLoop as JCohortStreamLoop
from repro.scale import VectorSimulator as JVectorSimulator
from repro.scale.cohort import cohort_mixing_matrix as j_cohort_mixing_matrix
from repro.scale.cohort import schedule_tables as j_schedule_tables
from repro_torch.core import coords
from repro_torch.core.mixing import schedule_from_addresses, schedule_mixing_matrix
from repro_torch.core.ndmp import Simulator, SimulatorProtocol
from repro_torch.kernels.gather_mix import gather_mix
from repro_torch.scale import CohortSampler, CohortStreamLoop, VectorSimulator
from repro_torch.scale.cohort import (cohort_addresses, cohort_mixing_matrix,
                                      cohort_schedule, schedule_tables)

KW = dict(num_spaces=3, latency=0.05, heartbeat_period=0.5, probe_period=1.0)


# --------------------------------------------------------------------------
# core/coords.py: the batch hasher and the ring helpers
# --------------------------------------------------------------------------

IDS = [0, 1, 7, 9, 10, 99, 123, 1000, 65_535, 10**12, 2**40 + 17, 2**63 - 1]


@pytest.mark.parametrize("salt,spaces", [("", 3), ("s", 4), ("trial-7|", 1)])
def test_coordinates_batch_is_bit_exact(salt, spaces):
    """Bit for bit the reference's batch and the port's scalar
    ``coordinate`` (ids of 1 to 19 digits, so the padded byte matrix
    masks ragged rows)."""
    got = coords.coordinates_batch(IDS, spaces, salt)
    assert got.dtype == np.float64 and got.shape == (len(IDS), spaces)
    np.testing.assert_array_equal(got, jcoords.coordinates_batch(IDS, spaces, salt))
    for i, u in enumerate(IDS):
        assert tuple(got[i]) == coords.coordinates(u, spaces, salt)
    assert coords.coordinates_batch([], spaces, salt).shape == (0, spaces)


def test_arcs_closer_and_ring_order_match_reference():
    rng = np.random.default_rng(3)
    xs = rng.random((64, 3)).tolist() + [[0.0, 0.5, 0.5], [0.25, 0.75, 0.5]]
    for x, y, t in xs:
        assert coords.ccw_arc(x, y) == jcoords.ccw_arc(x, y)
        assert coords.cw_arc(x, y) == jcoords.cw_arc(x, y)
        for tx, ty in ((0, 1), (1, 0), (2, 2)):
            assert coords.closer(x, y, t, tx, ty) == jcoords.closer(x, y, t, tx, ty)
    addrs = [coords.NodeAddress.create(u, 3) for u in range(40)]
    addrs.append(coords.NodeAddress(node_id=99, coords=addrs[5].coords))  # a tie
    j_addrs = [jcoords.NodeAddress(node_id=a.node_id, coords=a.coords) for a in addrs]
    for s in range(3):
        assert coords.ring_order(addrs, s) == jcoords.ring_order(j_addrs, s)


# --------------------------------------------------------------------------
# scale/ndmp_vec.py: VectorSimulator on fixed traces, step by step
# --------------------------------------------------------------------------

def _apply(sim, op):
    kind, *args = op
    if kind == "partition":
        sim.set_partition(args[0])
    elif kind == "heal":
        sim.heal_partition()
    elif kind == "scale":
        sim.set_delay_scale(args[0])
    elif kind == "run":
        sim.run_for(args[0])
    elif kind == "rejoin":
        sim.rejoin(args[0], 0)
    elif kind in ("join", "fail", "leave"):
        getattr(sim, f"{kind}_batch")(args[0])
    elif kind == "join1":
        sim.join(args[0])
    else:
        raise AssertionError(kind)


TRACES = {
    "churn": (30, [("join", range(130, 135)), ("run", 0.2), ("run", 8.0),
                   ("fail", [1, 4, 9]), ("leave", [2, 6]), ("run", 1.0),
                   ("run", 40.0)]),
    "partition": (24, [("scale", 1.0 / 0.9), ("partition", [range(12), range(12, 24)]),
                       ("run", 0.5), ("run", 5.0), ("heal",), ("run", 0.1),
                       ("run", 10.0)]),
    "rejoin": (12, [("fail", [4]), ("run", 30.0), ("join1", 4), ("run", 30.0),
                    ("rejoin", 5), ("run", 0.1), ("run", 5.0)]),
    # the reference's unsteady hypothesis case, shrunk: node 1000 joins
    # (through node 0 on the object engine) while node 0 fails
    "join0_fail0": (40, [("fail", [0]), ("join", [1000]), ("run", 0.3),
                         ("run", 60.0)]),
}


def _assert_same_engine_state(t, j):
    a, b = t.export_state(), j.export_state()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert t.alive_ids() == j.alive_ids()
    assert t.neighbor_tables() == j.neighbor_tables()
    assert t.correctness() == j.correctness()
    assert t.tables_version() == j.tables_version()
    for x, y in zip(t.neighbor_rows(), j.neighbor_rows()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", sorted(TRACES))
def test_vector_simulator_matches_reference(name):
    """After every call: ``export_state`` (ids, coordinates bit for bit,
    pointers, versions), ``neighbor_tables``, ``correctness`` and
    ``tables_version`` equal to the reference's (exact: the same numpy
    operations in the same order)."""
    n, ops = TRACES[name]
    t, j = VectorSimulator(**KW), JVectorSimulator(**KW)
    t.seed_network(range(n))
    j.seed_network(range(n))
    assert isinstance(t, SimulatorProtocol)
    _assert_same_engine_state(t, j)
    for op in ops:
        _apply(t, op)
        _apply(j, op)
        assert t.now == j.now and t.num_rows == j.num_rows
        _assert_same_engine_state(t, j)


def test_join0_fail0_case_matches_reference_on_both_engines():
    """The reference's unsteady fuzz case (``events=[('join', 0),
    ('fail', 0)]``, ``seed=0``), run as its test runs it: the object
    engine joins 1000 through node 0 and then fails 0; the vector engine
    takes the same churn in per-kind batches.  Each port engine equals
    the reference's engine of its kind, including where the object
    engine stops short of the vector engine's tables."""
    results = []
    for Obj, Vec in ((Simulator, VectorSimulator), (JSimulator, JVectorSimulator)):
        obj = Obj(seed=0, **KW)
        obj.seed_network(list(range(40)))
        vec = Vec(**KW)
        vec.seed_network(range(40))
        obj.join(1000, bootstrap=0)
        obj.fail(0)
        vec.fail_batch([0])
        vec.join_batch([1000])
        obj.run_for(60.0)
        vec.run_for(60.0)
        results.append((obj, vec))
    (t_obj, t_vec), (j_obj, j_vec) = results
    _assert_same_engine_state(t_vec, j_vec)
    assert t_obj.neighbor_tables() == j_obj.neighbor_tables()
    assert t_obj.correctness() == j_obj.correctness()
    assert t_vec.correctness() == 1.0
    for k, v in t_obj.export_state().items():
        np.testing.assert_array_equal(v, j_obj.export_state()[k], err_msg=k)


def test_from_simulator_and_confidence_match_reference():
    """A vector engine seeded from the (port's) object engine equals one
    seeded from the reference's; ``set_confidence`` lands on the rows."""
    t_obj, j_obj = Simulator(seed=1, **KW), JSimulator(seed=1, **KW)
    for sim in (t_obj, j_obj):
        sim.seed_network(list(range(25)))
        sim.fail(7)
        sim.run_for(30.0)
    t, j = VectorSimulator.from_simulator(t_obj), JVectorSimulator.from_simulator(j_obj)
    _assert_same_engine_state(t, j)
    assert t.neighbor_tables() == t_obj.neighbor_tables()
    t.set_confidence([3, 4], [0.25, 2.0])
    assert t.confidence[t._row_of[4]] == np.float32(2.0)


def test_vector_simulator_rejects_bad_ops():
    t = VectorSimulator(**KW)
    t.seed_network(range(10))
    with pytest.raises(ValueError):
        t.join_batch([3])
    with pytest.raises(KeyError):
        t.fail_batch([99])
    with pytest.raises(KeyError):
        t.rejoin(42, 0)
    with pytest.raises(ValueError):
        t.set_delay_scale(0.5)
    with pytest.raises(ValueError, match="overlap"):
        t.set_partition([[1, 2], [2, 3]])


# --------------------------------------------------------------------------
# scale/cohort.py
# --------------------------------------------------------------------------

L = 3


def _vec(n, cls=VectorSimulator):
    sim = cls(num_spaces=L, latency=0.05, heartbeat_period=0.5, probe_period=1.0)
    sim.seed_network(range(n))
    return sim


class FixedSampler:
    """Scripted cohorts — the last entry repeats."""

    def __init__(self, cohorts):
        self.cohorts = [tuple(sorted(c)) for c in cohorts]

    def sample(self, round_index):
        return self.cohorts[min(round_index, len(self.cohorts) - 1)]


def _params(dim):
    return lambda u: np.random.default_rng(u).random(dim).astype(np.float32)


def test_cohort_round_equals_dense_oracle_and_reference_tables():
    """Three compositions: the port's tables and dense matrix equal the
    reference's exactly; ``gather_mix`` with a tensor of sources (the
    plain version on the CPU) equals ``M @ buf`` in f64 within 1e-6."""
    capacity, dim = 16, 64
    buf = np.random.default_rng(0).random((capacity, dim), dtype=np.float32)
    for cohort in (tuple(range(10)), tuple(range(5, 17)), tuple(2 * k for k in range(8))):
        slot_of = {u: i for i, u in enumerate(cohort)}
        _, padded = cohort_schedule(cohort, L, slot_of, capacity)
        srcs, weights = schedule_tables(padded)
        js, jw = j_schedule_tables(padded)
        np.testing.assert_array_equal(srcs, js)
        np.testing.assert_array_equal(weights, jw)
        M = cohort_mixing_matrix(cohort, L, slot_of, capacity)
        np.testing.assert_array_equal(M, j_cohort_mixing_matrix(cohort, L, slot_of, capacity))
        out = gather_mix(torch.from_numpy(buf), torch.from_numpy(srcs),
                         torch.from_numpy(weights))
        assert np.abs(out.numpy() - M @ buf.astype(np.float64)).max() <= 1e-6


def test_full_population_cohort_is_full_participation():
    n, capacity = 12, 16
    cohort = tuple(range(n))
    slot_of = {u: i for i, u in enumerate(cohort)}
    M = cohort_mixing_matrix(cohort, L, slot_of, capacity)
    dense = schedule_mixing_matrix(schedule_from_addresses(cohort_addresses(cohort, L)))
    np.testing.assert_array_equal(M[:n, :n], dense)
    np.testing.assert_array_equal(M[n:, n:], np.eye(capacity - n))
    np.testing.assert_array_equal(M[:n, n:], 0.0)


@pytest.mark.parametrize("weighted", [False, True])
def test_sampler_draws_the_references_cohorts(weighted):
    t, j = _vec(300), _vec(300, JVectorSimulator)
    for sim in (t, j):
        sim.set_confidence(range(300), [1.0 + (u % 7) for u in range(300)])
    ts, js = CohortSampler(t, 17, seed=5, weighted=weighted), \
        JCohortSampler(j, 17, seed=5, weighted=weighted)
    for r in range(4):
        assert ts.sample(r) == js.sample(r)
    assert CohortSampler(t, 500).sample(0) == tuple(t.alive_ids())
    with pytest.raises(ValueError):
        CohortSampler(t, 0)


def _record_fields(r):
    return (r.round, r.time, r.cohort_size, r.streamed_in, r.streamed_out,
            r.restored, r.donor_seeded, r.fresh, r.evicted)


def _assert_loops_agree(t, j):
    """Equal records (all but the host's remap ms and the reference's
    retrace count), the same slots and park, and the rows within 1e-6 x
    max|buf| (mixing sums taken in another order)."""
    assert [_record_fields(r) for r in t.records] == [_record_fields(r) for r in j.records]
    assert t.slots.slot_of == j.slots.slot_of
    assert list(t.park) == list(j.park)
    jbuf = np.asarray(j.buf)
    scale = float(np.abs(jbuf).max())
    np.testing.assert_allclose(t.buf.numpy(), jbuf, rtol=0, atol=1e-6 * scale)
    for u in t.park:
        np.testing.assert_allclose(t.park[u], j.park[u], rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("k", [8, 16, 32])
def test_cohort_stream_matches_reference(k):
    """The reference benchmark's quick stream (n 2000, capacity 32, dim
    256, 8 rounds, a 1 % fail and join burst at mid-run) for cohort K:
    held to the reference's loop (``_assert_loops_agree``); the two
    resident buffers keep their storage across every round and the
    burst."""
    n, capacity, dim, rounds = 2000, 32, 256, 8
    loops = []
    for Sim, Loop, kw in ((VectorSimulator, CohortStreamLoop, {"device": "cpu"}),
                          (JVectorSimulator, JCohortStreamLoop, {})):
        sim = _vec(n, Sim)
        loop = Loop(sim, capacity=capacity, cohort_size=k,
                    make_params=_params(dim), seed=3, **kw)
        loop.run(rounds // 2)
        burst = n // 100
        sim.fail_batch(range(burst))
        sim.join_batch(range(n + 1000, n + 1000 + burst))
        sim.run_for(30.0)
        if kw:
            ptrs = {loop.buf.data_ptr(), loop.spare.data_ptr()}
        loop.run(rounds - rounds // 2)
        loops.append(loop)
    t, j = loops
    _assert_loops_agree(t, j)
    assert {t.buf.data_ptr(), t.spare.data_ptr()} == ptrs
    assert sum(r.streamed_in for r in t.records) > k


@pytest.mark.parametrize("case", ["snapshot", "forgotten", "unbounded"])
def test_park_lru_snapshot_restore_matches_reference(case):
    """LRU park with and without a snapshot/restore policy, on scripted
    cohorts: records, park order, the snapshot store and every client's
    row held to the reference's (``_assert_loops_agree``)."""
    cohorts = {"snapshot": [(0, 1, 2, 3), (4, 5, 6, 7), (8, 9, 10, 11), (0, 1, 2, 3)],
               "forgotten": [(0, 1, 2, 3), (4, 5, 6, 7), (8, 9, 10, 11), (0, 8, 9, 10)],
               "unbounded": [tuple(range(4 * r, 4 * r + 4)) for r in range(4)]}[case]
    loops, stores = [], []
    for Loop, kw in ((CohortStreamLoop, {"device": "cpu"}), (JCohortStreamLoop, {})):
        store = {}
        policy = ({} if case != "snapshot" else dict(
            snapshot_fn=lambda u, row, s=store: s.__setitem__(u, np.array(row)),
            restore_fn=lambda u, s=store: s.get(u)))
        loop = Loop(_vec(20), capacity=4, cohort_size=4, make_params=_params(16),
                    sampler=FixedSampler(cohorts),
                    max_parked=None if case == "unbounded" else 4, **policy, **kw)
        loop.run(4)
        loops.append(loop)
        stores.append(store)
    t, j = loops
    _assert_loops_agree(t, j)
    assert t.evictions == j.evictions
    assert sorted(stores[0]) == sorted(stores[1])
    for u in stores[0]:
        np.testing.assert_allclose(stores[0][u], stores[1][u], rtol=0, atol=1e-6)
    for u in range(12):
        try:
            want = j.client_params(u)
        except KeyError:
            with pytest.raises(KeyError):
                t.client_params(u)
            continue
        np.testing.assert_allclose(t.client_params(u), want, rtol=0, atol=1e-6)
    if case == "snapshot":
        assert t.records[-1].restored == 4
    if case == "forgotten":
        assert t.records[-1].donor_seeded == 1


def test_loop_rounds_equal_dense_oracle_and_keep_storage():
    """With a stable cohort every round is buf <- M @ buf (f64 oracle,
    within 1e-6), written into the spare buffer, and the two buffers
    only swap roles."""
    cohort = (0, 1, 2, 3, 4)
    loop = CohortStreamLoop(_vec(10), capacity=6, cohort_size=5, make_params=_params(32),
                            sampler=FixedSampler([cohort]), device="cpu",
                            local_fn=lambda buf, mask: buf)
    loop.run(1)
    M = cohort_mixing_matrix(cohort, L, dict(loop.slots.slot_of), 6)
    ptrs = {loop.buf.data_ptr(), loop.spare.data_ptr()}
    for _ in range(3):
        before = loop.buf.numpy().astype(np.float64)
        spare = loop.spare.data_ptr()
        loop.run(1)
        assert loop.buf.data_ptr() == spare
        assert np.abs(loop.buf.numpy() - M @ before).max() <= 1e-6
    assert {loop.buf.data_ptr(), loop.spare.data_ptr()} == ptrs
    assert loop.mask.tolist() == [1.0] * 5 + [0.0]


def test_loop_validates_its_arguments():
    with pytest.raises(ValueError, match="exceeds"):
        CohortStreamLoop(_vec(8), capacity=4, cohort_size=8, make_params=_params(4),
                         device="cpu")
    with pytest.raises(ValueError, match="max_parked"):
        CohortStreamLoop(_vec(8), capacity=4, cohort_size=4, make_params=_params(4),
                         max_parked=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            CohortStreamLoop(_vec(8), capacity=4, cohort_size=4, make_params=_params(4))
