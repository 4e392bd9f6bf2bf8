"""The port's churn plane against the JAX package on the CPU: what
``overlay/events.py`` gained (``ChurnTrace.horizon`` and ``stochastic``,
``TableDelta.empty`` and ``num_affected``, ``DeltaTracker.tables``) and
the re-stacking ``ChurnTrainLoop`` over ``dfl_train_bundle(sync="none")``
on a small language model under a scripted fail, rejoin and join.  The
same numpy inputs and parameters go to both packages; each tolerance is
stated where it is used."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ndmp import Simulator as JSimulator
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import dfl_train_bundle as j_dfl_train_bundle
from repro.launch.train import tiny_lm as j_tiny_lm
from repro.models.config import INPUT_SHAPES
from repro.models.model import init_params as j_init_params
from repro.obs.rounds import RoundLedger as JRoundLedger
from repro.optim import optimizers as jopt
from repro.overlay import ChurnTrace as JChurnTrace
from repro.overlay import ChurnTrainLoop as JChurnTrainLoop
from repro.overlay import DeltaTracker as JDeltaTracker
from repro.overlay import OverlayController as JController
from repro_torch.configs import tiny_lm
from repro_torch.core.ndmp import Simulator
from repro_torch.dist.flat import tree_flatten
from repro_torch.launch.steps import dfl_train_bundle
from repro_torch.models.convert import tree_from_numpy
from repro_torch.obs.rounds import RoundLedger
from repro_torch.optim import optimizers as topt
from repro_torch.overlay import (ChurnTrace, ChurnTrainLoop, DeltaTracker,
                                 OverlayController, joiner_donors)

KW = dict(num_spaces=2, latency=0.05, heartbeat_period=0.5, probe_period=1.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep each xdist worker's intra-op pool small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _sim(cls, n, seed=0):
    sim = cls(seed=seed, **KW)
    sim.seed_network(list(range(n)))
    return sim


# --------------------------------------------------------------------------
# overlay/events.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_stochastic_trace_is_the_references(seed):
    """Poisson churn from the same seed: the same events (times bit for
    bit, kinds, ids) and horizon."""
    kw = dict(horizon=40.0, join_rate=0.3, fail_rate=0.2, leave_rate=0.1,
              initial_ids=range(12), first_new_id=500, min_alive=6, seed=seed)
    t, j = ChurnTrace.stochastic(**kw), JChurnTrace.stochastic(**kw)
    assert [(e.time, e.kind, e.node_id, e.bootstrap) for e in t.events] == \
        [(e.time, e.kind, e.node_id, e.bootstrap) for e in j.events]
    assert len(t.events) > 5
    assert t.horizon == j.horizon == t.events[-1].time
    assert ChurnTrace.scripted([]).horizon == 0.0
    assert ChurnTrace.stochastic(horizon=5.0, seed=seed).events == ()


def test_table_deltas_and_tracker_tables_match_reference():
    """Deltas of the same churn, poll by poll: ``empty``,
    ``num_affected``, the epoch and the tracker's table snapshot."""
    sims = [_sim(Simulator, 10), _sim(JSimulator, 10)]
    trackers = [DeltaTracker(sims[0]), JDeltaTracker(sims[1])]
    script = [(None,), ("fail", 3), (None,), ("join", 40), ("leave", 5), (None,)]
    for op in script:
        deltas = []
        for sim, tr in zip(sims, trackers):
            if op[0] == "join":
                sim.join(op[1], bootstrap=0)
            elif op[0] is not None:
                getattr(sim, op[0])(op[1])
            sim.run_for(4.0)
            deltas.append(tr.poll())
        a, b = deltas
        assert (a.epoch, a.empty, a.num_affected, a.joined, a.left) == \
            (b.epoch, b.empty, b.num_affected, b.joined, b.left)
        assert trackers[0].tables == trackers[1].tables
    assert deltas[0].empty


# --------------------------------------------------------------------------
# overlay/runtime.py: ChurnTrainLoop on a small language model
# --------------------------------------------------------------------------

SEQ = 32
# one layer keeps the reference's compiles short (it compiles a local
# step for every alive count and a mixer for every schedule)
J_CFG, CFG = j_tiny_lm(vocab=256, d_model=64, layers=1), tiny_lm(vocab=256, d_model=64, layers=1)
#: a fail, the same id's rejoin (the first alive set again: a cache
#: hit), a new id's join
CHURN = [(1.5, "fail", 1), (4.5, "join", 1, 0), (6.5, "join", 50, 0)]
STEPS = 9
_j_init = jax.jit(lambda key: j_init_params(J_CFG, key, dtype=jnp.float32))


@functools.lru_cache(maxsize=None)
def _params(node_id):
    return jax.tree.map(np.asarray, _j_init(jax.random.PRNGKey(node_id)))


def _batch(node_ids, step):
    return {k: np.stack([np.random.default_rng([u, step, i]).integers(
        0, J_CFG.vocab_size, (2, SEQ)) for u in node_ids]).astype(np.int32)
        for i, k in enumerate(("tokens", "labels"))}


class CheckedLoop(ChurnTrainLoop):
    """Holds every remap to node identity as it lands: each survivor's
    rows moved bit for bit, each joiner's row its donor's."""

    moves = 0

    def _remap(self, report):
        old, old_params = self.assignment, self.params
        joined, left = super()._remap(report)
        new = self.assignment
        donors = joiner_donors(self.controller.schedule, new, joined,
                               [u for u in new if u in old])
        for u in new:
            src = old.index(u) if u in old else (old.index(donors[u])
                                                  if donors[u] is not None else None)
            if src is None:
                continue
            for a, b in zip(tree_flatten(self.params)[0], tree_flatten(old_params)[0]):
                assert torch.equal(a[new.index(u)], b[src])
            CheckedLoop.moves += 1
        return joined, left


@pytest.fixture(scope="module")
def churn_runs():
    """The same churn trace through the reference's ChurnTrainLoop and
    the port's, sgd(0.05), fedlay over 2 spaces through the flat mixer,
    2 sequences of 32 tokens a client and step."""
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=2, seq_len=SEQ)
    j_bundle = j_dfl_train_bundle(J_CFG, shape, make_local_mesh(1, 1), jopt.sgd(0.05),
                                  dtype=jnp.float32, sync="none")
    t_bundle = dfl_train_bundle(CFG, shape, 1, topt.sgd(0.05), sync="none")
    jl, tl = JRoundLedger(), RoundLedger()
    j_sim = JController(_sim(JSimulator, 4), fuse="flat")
    jloop = JChurnTrainLoop(
        j_sim, local_step=j_bundle.step,
        make_params=lambda u: jax.tree.map(jnp.asarray, _params(u)),
        optimizer=jopt.sgd(0.05), ledger=jl,
        make_batch=lambda ids, s: {k: jnp.asarray(v) for k, v in _batch(ids, s).items()})
    tloop = CheckedLoop(
        OverlayController(_sim(Simulator, 4), fuse="flat"), local_step=t_bundle.step,
        make_params=lambda u: tree_from_numpy(_params(u)),
        optimizer=topt.sgd(0.05), ledger=tl,
        make_batch=lambda ids, s: {k: torch.from_numpy(v) for k, v in _batch(ids, s).items()})
    jrec = jloop.run(STEPS, trace=JChurnTrace.scripted(CHURN))
    trec = tloop.run(STEPS, trace=ChurnTrace.scripted(CHURN))
    return jloop, tloop, jrec, trec, jl, tl


def test_churn_loop_records_match_reference(churn_runs):
    """Equal records (step, time, alive count, swapped, cache hit,
    joined, left), the revisit a cache hit, and each step's loss within
    1e-5 relative (f32 on both sides, sums in another order)."""
    jloop, tloop, jrec, trec, jl, tl = churn_runs
    fields = lambda r: (r.step, r.time, r.num_alive, r.swapped, r.cache_hit,  # noqa: E731
                        r.joined, r.left)
    assert [fields(r) for r in trec] == [fields(r) for r in jrec]
    assert [r.num_alive for r in trec] == [4, 3, 3, 3, 4, 4, 5, 5, 5]
    revisit = trec[4]
    assert revisit.joined == (1,) and revisit.swapped and revisit.cache_hit
    for a, b in zip(trec, jrec):
        assert abs(a.loss - b.loss) <= 1e-5 * abs(b.loss)
    assert tloop.assignment == jloop.assignment
    keys = ("num_alive", "wire_bytes_per_client", "swapped", "cache_hit", "joined", "left")
    assert [tuple(r.extra.get(k, getattr(r, k, None)) for k in keys) for r in tl.rows] == \
        [tuple(getattr(r, k) for k in keys) for r in jl.rows]


def test_churn_loop_params_match_reference(churn_runs):
    """Every live client's parameters within 1e-5 x max|p| of the
    reference's after the last step, and every remap moved rows by node
    identity (``CheckedLoop``)."""
    jloop, tloop, *_ = churn_runs
    assert CheckedLoop.moves >= 4 + 3 + 1
    for u in tloop.assignment:
        want = jax.tree.leaves(jax.tree.map(np.asarray, jloop.client_params(u)))
        got = tree_flatten(tloop.client_params(u))[0]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * float(np.abs(w).max()))


def test_unmasked_bundle_step_takes_any_row_count():
    """``sync="none"``: the unmasked step trains as many rows as it is
    given (the re-stacking loop hands it the alive count), and the loss
    is their mean."""
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=2, seq_len=SEQ)
    step = dfl_train_bundle(CFG, shape, 1, topt.sgd(0.05), sync="none").step
    for n in (1, 3):
        ids = tuple(range(n))
        params = tree_from_numpy(jax.tree.map(lambda *ls: np.stack(ls),
                                              *[_params(u) for u in ids]))
        before = [l.clone() for l in tree_flatten(params)[0]]
        batch = {k: torch.from_numpy(v) for k, v in _batch(ids, 0).items()}
        _, _, m = step(params, (), batch)
        assert np.isfinite(float(m["loss"]))
        for a, b in zip(tree_flatten(params)[0], before):
            assert all(not torch.equal(a[i], b[i]) for i in range(n))
