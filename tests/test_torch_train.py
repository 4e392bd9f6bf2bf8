"""The port's DFL training round against the JAX reference on the CPU:
``forward`` / ``train_loss``, the optimizers, the masked local step, and
``SlotTrainLoop`` under churn (the quadratic step of
``tests/test_runtime.py`` and a small language model), plus
``ServeLoop.reload_from_flat``.  Same numpy inputs and parameters on
both sides; each tolerance is stated where it is used."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import reduce_for_smoke as j_reduce
from repro.core.ndmp import Simulator as JSimulator
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import dfl_train_bundle
from repro.launch.train import tiny_lm as j_tiny_lm
from repro.models.config import INPUT_SHAPES
from repro.models.model import forward as j_forward
from repro.models.model import init_params as j_init_params
from repro.models.model import train_loss as j_train_loss
from repro.optim import optimizers as jopt
from repro.overlay.controller import OverlayController as JController
from repro.overlay.events import ChurnTrace as JChurnTrace
from repro.runtime.loop import SlotTrainLoop as JSlotTrainLoop
from repro.runtime.masked import masked_local_step as j_masked_local_step
from repro.runtime.serving import ServeLoop as JServeLoop
from repro_torch.configs import REGISTRY, reduce_for_smoke
from repro_torch.configs import tiny_lm as t_tiny_lm
from repro_torch.core.ndmp import Simulator
from repro_torch.dist.flat import FlatSpec, tree_flatten
from repro_torch.launch.steps import dfl_local_step
from repro_torch.models.convert import module_state, params_from_jax, tree_from_numpy
from repro_torch.models.model import forward, init_params, train_loss
from repro_torch.optim import optimizers as topt
from repro_torch.overlay.controller import OverlayController
from repro_torch.overlay.events import ChurnTrace
from repro_torch.runtime.loop import SlotTrainLoop
from repro_torch.runtime.masked import (masked_local_step, masked_mean,
                                        participation_mask)
from repro_torch.runtime.serving import ServeLoop

J_CFG = j_reduce(J_REGISTRY["llama3.2-3b"])
CFG = reduce_for_smoke(REGISTRY["llama3.2-3b"])


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep each xdist worker's intra-op pool small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed, batch=2, seq=16, vocab=None):
    rng = np.random.default_rng(seed)
    v = vocab or CFG.vocab_size
    return {"tokens": rng.integers(0, v, (batch, seq)).astype(np.int32),
            "labels": rng.integers(0, v, (batch, seq)).astype(np.int32)}


def _sim(cls, n, L=2):
    sim = cls(num_spaces=L, latency=0.05, heartbeat_period=0.5,
              probe_period=1.0, seed=0)
    sim.seed_network(list(range(n)))
    return sim


# --------------------------------------------------------------------------
# forward, train_loss, one SGD step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-4b"])
def test_forward_and_train_loss_match_jax(arch):
    """Logits within 1e-4 x max|logits| and the loss within 1e-5
    relative: f32 on both sides, sums taken in another order."""
    jcfg, tcfg = j_reduce(J_REGISTRY[arch]), reduce_for_smoke(REGISTRY[arch])
    params = j_init_params(jcfg, jax.random.PRNGKey(1))
    tree = tree_from_numpy(_np(params))
    b = _batch(2, vocab=jcfg.vocab_size)
    jl, _ = j_forward(jcfg, params, jnp.asarray(b["tokens"]))
    tl, aux = forward(tcfg, tree, torch.from_numpy(b["tokens"]))
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4 * scale)
    assert float(aux) == 0.0
    jloss = float(j_train_loss(jcfg, params, {k: jnp.asarray(v) for k, v in b.items()}))
    tloss = float(train_loss(tcfg, tree, {k: torch.from_numpy(v) for k, v in b.items()}))
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)


def test_one_sgd_step_delta_matches_jax():
    """value_and_grad, clip 1.0, sgd(0.05): the parameter change within
    1e-5 x max|delta| (gradients in f32 through two autodiff systems)
    plus one f32 spacing of the largest new parameter, since p + u rounds to
    the parameter's grid and a tiny difference in u can move it one step."""
    params = j_init_params(J_CFG, jax.random.PRNGKey(3))
    b = _batch(4)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    opt = jopt.sgd(0.05)

    @jax.jit
    def j_step(p):
        loss, g = jax.value_and_grad(lambda q: j_train_loss(J_CFG, q, jb))(p)
        g, _ = jopt.clip_by_global_norm(g, 1.0)
        upd, _ = opt.update(g, opt.init(p), p)
        return loss, jopt.apply_updates(p, upd)
    loss, j_new = j_step(params)
    j_new = _np(j_new)

    stacked = tree_from_numpy(jax.tree.map(lambda l: np.asarray(l)[None], params))
    step = dfl_local_step(CFG, topt.sgd(0.05))
    tb = {k: torch.from_numpy(v)[None] for k, v in b.items()}
    _, _, m = step(stacked, (), tb, np.ones(1, np.float32))
    assert abs(float(m["loss"]) - float(loss)) <= 1e-5 * float(loss)
    for (path, want), got, before in zip(
            jax.tree_util.tree_leaves_with_path(j_new),
            tree_flatten(stacked)[0], jax.tree.leaves(_np(params))):
        delta_j = want - before
        delta_t = got[0].numpy() - before
        atol = 1e-5 * np.abs(delta_j).max() + np.spacing(np.abs(want).max())
        np.testing.assert_allclose(delta_t, delta_j, rtol=0, atol=atol,
                                   err_msg=str(path))


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": (lambda m: m.sgd(0.1), 1),
    "sgd_momentum": (lambda m: m.sgd(0.1, momentum=0.9), 3),
    "sgd_nesterov_wd": (lambda m: m.sgd(0.1, momentum=0.9, nesterov=True,
                                        weight_decay=0.01), 3),
    "adamw": (lambda m: m.adamw(1e-2), 3),
    "adamw_cosine": (lambda m: m.adamw(1e-2, lr_schedule=m.cosine_schedule(2, 10)), 3),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(name):
    """Three updates on the same gradients: parameters within 1e-6
    relative (f32 element-wise math, same formulas, in place here)."""
    make, steps = OPTIMIZERS[name]
    rng = np.random.default_rng(7)
    p = {"a": rng.normal(size=(5, 3)).astype(np.float32),
         "b": {"c": rng.normal(size=(4,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda l: rng.normal(size=l.shape).astype(np.float32), p)
             for _ in range(steps)]
    jo, to = make(jopt), make(topt)
    jp, js = jax.tree.map(jnp.asarray, p), None
    js = jo.init(jp)
    tp = tree_from_numpy(p)
    ts = to.init(tp)
    for g in grads:
        upd, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jopt.apply_updates(jp, upd)
        tupd, ts = to.update(tree_from_numpy(g), ts, tp)
        topt.apply_updates_(tp, tupd)
    for want, got in zip(jax.tree.leaves(_np(jp)), tree_flatten(tp)[0]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_clip_by_global_norm_and_out_of_place_apply_match_jax():
    rng = np.random.default_rng(0)
    g = {"x": rng.normal(size=(6,)).astype(np.float32) * 3,
         "y": rng.normal(size=(2, 2)).astype(np.float32)}
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tg, tn = topt.clip_by_global_norm(tree_from_numpy(g), 1.0)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    for want, got in zip(jax.tree.leaves(_np(jg)), tree_flatten(tg)[0]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    p = tree_from_numpy(g)
    out = topt.apply_updates(p, tg)
    assert out["x"].data_ptr() != p["x"].data_ptr()
    np.testing.assert_allclose(out["x"].numpy(), g["x"] + tg["x"].numpy(), rtol=1e-6)


# --------------------------------------------------------------------------
# the mask helpers
# --------------------------------------------------------------------------

def test_masked_mean_and_participation_mask():
    v = torch.tensor([1.0, float("nan"), 3.0])
    assert float(masked_mean(v, torch.tensor([1.0, 0.0, 1.0]))) == 2.0
    assert float(masked_mean(v, torch.zeros(3))) == 0.0
    assert participation_mask([1, 2, 3], 4).tolist() == [1.0, 1.0, 0.0]


# --------------------------------------------------------------------------
# SlotTrainLoop on the quadratic step (tests/test_runtime.py:350-385)
# --------------------------------------------------------------------------

DIM = 32


def _rows(node_ids, step):
    return np.stack([np.random.default_rng(abs(hash((u, step))) % 2**32)
                     .normal(size=DIM).astype(np.float32) for u in node_ids])


def _init_row(u):
    return np.random.default_rng(u).normal(size=DIM).astype(np.float32)


def _j_step(params, opt_state, batch):
    w, x = params["w"], batch["x"]
    loss = jnp.mean((w - x) ** 2, axis=-1)
    return {"w": w - 0.05 * 2.0 * (w - x) / DIM}, opt_state, {"loss": loss}


def _t_step(params, opt_state, batch):
    w, x = params["w"], batch["x"]
    loss = ((w - x) ** 2).mean(dim=-1)
    return {"w": w - 0.05 * 2.0 * (w - x) / DIM}, opt_state, {"loss": loss}


def _churn(cls):
    return cls.scripted([(2.5, "fail", 1), (4.5, "fail", 3),
                         (6.5, "join", 100, 0), (8.5, "join", 101, 0)])


def _resident_ptrs(loop):
    return {loop.params.data_ptr(), loop._spare.data_ptr()}


PERIODS = {0: 1.0, 1: 2.0, 2: 1.0, 3: 3.0, 4: 2.0, 5: 1.0, 100: 2.0, 101: 1.0}
FAULTS = dict(down_pairs=frozenset({(0, 4)}), slow_nodes=frozenset({2}))


def _with_faults(cls, faults_cls):
    """A simulator that reports data-plane faults, as a chaos engine
    does: the slot loop then runs degraded rounds through edge_mask."""
    class Faulty(cls):
        def data_faults(self):
            return faults_cls(**FAULTS)
    return Faulty


@pytest.mark.parametrize("variant", ["flat_io", "periods", "faults"])
def test_slot_loop_quadratic_matches_jax(variant):
    """Same alive sequence and churn, losses within 1e-5, the population
    within 1e-5; the resident buffers keep their storage across the
    churn.  ``periods`` adds multirate participation, ``faults`` a
    simulator with data-plane faults (degraded rounds)."""
    from repro.faults.plan import DataFaults as JDataFaults
    from repro_torch.faults.plan import DataFaults
    periods = PERIODS if variant == "periods" else None
    from repro.obs.rounds import RoundLedger as JRoundLedger
    from repro_torch.obs.rounds import RoundLedger
    jledger, tledger = JRoundLedger(), RoundLedger()
    jsim_cls = (_with_faults(JSimulator, JDataFaults) if variant == "faults"
                else JSimulator)
    tsim_cls = (_with_faults(Simulator, DataFaults) if variant == "faults"
                else Simulator)
    jloop = JSlotTrainLoop(
        JController(_sim(jsim_cls, 6), capacity=8, fuse="flat", flat_io=True),
        local_step=j_masked_local_step(_j_step),
        make_params=lambda u: {"w": jnp.asarray(_init_row(u))},
        optimizer=jopt.sgd(0.0), periods=periods, ledger=jledger,
        make_batch=lambda ids, s: {"x": jnp.asarray(_rows(ids, s))})
    jrec = jloop.run(12, trace=_churn(JChurnTrace))
    tloop = SlotTrainLoop(
        OverlayController(_sim(tsim_cls, 6), capacity=8, fuse="flat",
                          flat_io=True),
        local_step=masked_local_step(_t_step),
        make_params=lambda u: {"w": torch.from_numpy(_init_row(u))},
        optimizer=topt.sgd(0.0), periods=periods, ledger=tledger,
        make_batch=lambda ids, s: {"x": torch.from_numpy(_rows(ids, s))})
    ptrs = _resident_ptrs(tloop)
    trec = tloop.run(12, trace=_churn(ChurnTrace))
    assert [(r.num_alive, r.participating) for r in trec] == \
        [(r.num_alive, r.participating) for r in jrec]
    assert [(r.joined, r.left) for r in trec] == [(r.joined, r.left) for r in jrec]
    assert tloop.controller.alive == jloop.controller.alive
    keys = ("wire_bytes_per_client", "degraded_edges", "swapped", "cache_hit")
    assert [tuple(r.extra[k] for k in keys) for r in tledger.rows] == \
        [tuple(getattr(r, k) for k in keys) for r in jledger.rows]
    assert variant != "faults" or sum(r.extra["degraded_edges"] for r in tledger.rows)
    np.testing.assert_allclose([r.loss for r in trec], [r.loss for r in jrec],
                               rtol=0, atol=1e-5)
    assert _resident_ptrs(tloop) == ptrs
    for u in tloop.controller.alive:
        np.testing.assert_allclose(tloop.client_params(u)["w"].numpy(),
                                   np.asarray(jloop.client_params(u)["w"]),
                                   rtol=0, atol=1e-5)


def _bare_loop(controller):
    return SlotTrainLoop(controller, local_step=masked_local_step(_t_step),
                         make_params=lambda u: {"w": torch.zeros(DIM)},
                         optimizer=topt.sgd(0.0),
                         make_batch=lambda ids, s: {"x": torch.zeros(len(ids), DIM)})


def test_slot_loop_requires_capacity_controller():
    with pytest.raises(ValueError, match="capacity"):
        _bare_loop(OverlayController(_sim(Simulator, 4)))


def test_slot_loop_requires_flat_resident_controller():
    """The port keeps the population resident flat only."""
    with pytest.raises(ValueError, match="flat_io=True"):
        _bare_loop(OverlayController(_sim(Simulator, 4), capacity=6))


# --------------------------------------------------------------------------
# SlotTrainLoop on a small language model, against dfl_train_bundle
# --------------------------------------------------------------------------

CAPACITY, SEQ = 4, 32
# the loop's model: tiny_lm at one layer keeps the JAX compile short
LM_J_CFG, LM_CFG = j_tiny_lm(vocab=256, d_model=64, layers=1), \
    t_tiny_lm(vocab=256, d_model=64, layers=1)
LM_CHURN = [(1.5, "fail", 1), (2.5, "join", 50, 0)]


_j_lm_init = jax.jit(lambda key: j_init_params(LM_J_CFG, key, dtype=jnp.float32))


@functools.lru_cache(maxsize=None)
def _lm_params(node_id):
    return _j_lm_init(jax.random.PRNGKey(node_id))


def _lm_rows(node_ids, step):
    out = {}
    for k in ("tokens", "labels"):
        out[k] = np.stack([np.random.default_rng(abs(hash((u, step, k))) % 2**32)
                           .integers(0, LM_J_CFG.vocab_size, (1, SEQ)) for u in node_ids]
                          ).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def lm_runs():
    """One JAX and one port run of 4 rounds, capacity 4, 3 live, a fail
    and a join, sgd(0.05), fedlay over 2 spaces with resident flat
    parameters, with the population captured after round 1."""
    opt_j = jopt.sgd(0.05)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"],
                                global_batch=CAPACITY, seq_len=SEQ)
    bundle = dfl_train_bundle(LM_J_CFG, shape, make_local_mesh(1, 1), opt_j,
                              dtype=jnp.float32, sync="none", masked=True)
    jloop = JSlotTrainLoop(
        JController(_sim(JSimulator, 3), capacity=CAPACITY, fuse="flat",
                    flat_io=True),
        local_step=bundle.step, make_params=_lm_params, optimizer=opt_j,
        make_batch=lambda ids, s: {k: jnp.asarray(v)
                                   for k, v in _lm_rows(ids, s).items()})
    tloop = SlotTrainLoop(
        OverlayController(_sim(Simulator, 3), capacity=CAPACITY, fuse="flat",
                          flat_io=True),
        local_step=dfl_local_step(LM_CFG, topt.sgd(0.05)),
        make_params=lambda u: tree_from_numpy(_np(_lm_params(u))),
        optimizer=topt.sgd(0.05),
        make_batch=lambda ids, s: {k: torch.from_numpy(v)
                                   for k, v in _lm_rows(ids, s).items()})
    ptrs = _resident_ptrs(tloop)
    trace_j, trace_t = JChurnTrace.scripted(LM_CHURN), ChurnTrace.scripted(LM_CHURN)
    jloop.run(1, trace=trace_j)
    tloop.run(1, trace=trace_t)
    after_one = (np.asarray(jloop.params), tloop.params.numpy().copy())
    jloop.run(3, trace=trace_j)
    tloop.run(3, trace=trace_t)
    return jloop, tloop, after_one, ptrs


def test_slot_loop_lm_matches_jax(lm_runs):
    """Same alive sequence and churn; per-round loss within 1e-4
    relative; the flat buffer after round 1 within 1e-5 x max|buf| (one
    f32 SGD step and one mixing round, sums in another order)."""
    jloop, tloop, (jbuf, tbuf), _ = lm_runs
    jrec, trec = jloop.records, tloop.records
    assert [r.num_alive for r in trec] == [r.num_alive for r in jrec] == [3, 2, 3, 3]
    assert [(r.joined, r.left) for r in trec] == [(r.joined, r.left) for r in jrec]
    for a, b in zip(trec, jrec):
        assert abs(a.loss - b.loss) <= 1e-4 * abs(b.loss)
    assert tbuf.shape == jbuf.shape
    np.testing.assert_allclose(tbuf, jbuf, rtol=0, atol=1e-5 * np.abs(jbuf).max())


def test_slot_loop_lm_keeps_its_storage_and_dead_rows(lm_runs):
    """Zero reallocation: the two population buffers keep their storage
    over the churn; the flat layout is the reference's; a dead slot's
    row is never written."""
    jloop, tloop, _, ptrs = lm_runs
    assert _resident_ptrs(tloop) == ptrs
    assert tloop.params.shape == tuple(np.shape(jloop.params))
    # slot 3 was never occupied: zeros from the start
    assert not tloop.params[3].any()


def test_joiner_row_is_its_donors_row():
    """The joiner's row equals its donor's, bit for bit, right after the
    plan lands (before the round's local step)."""
    loop = SlotTrainLoop(
        OverlayController(_sim(Simulator, 3), capacity=CAPACITY, fuse="flat",
                          flat_io=True),
        local_step=lambda p, o, b, m: (p, o, {"loss": torch.zeros(())}),
        make_params=lambda u: init_params(LM_CFG, torch.Generator().manual_seed(u)),
        optimizer=topt.sgd(0.05), make_batch=lambda ids, s: {})
    loop.run(1)
    ctl = loop.controller
    ctl.step(1.0, trace=ChurnTrace.scripted([(1.2, "join", 50, 0)]))
    plan = ctl.commit()
    joined, _ = loop._apply_plan(plan)
    assert joined == (50,)
    from repro_torch.overlay.runtime import joiner_donors
    donor = joiner_donors(ctl.alive_schedule, ctl.alive, (50,), (0, 1, 2))[50]
    assert donor is not None
    assert torch.equal(loop.params[ctl.slots.slot_of[50]],
                       loop.params[ctl.slots.slot_of[donor]])


# --------------------------------------------------------------------------
# ServeLoop.reload_from_flat
# --------------------------------------------------------------------------

def test_reload_from_flat_serves_like_reload():
    """The port's reload_from_flat and the JAX reload of the same row
    generate the same tokens."""
    from repro.dist.flat import FlatSpec as JFlatSpec
    jcfg, tcfg = j_tiny_lm(layers=2), t_tiny_lm(layers=2)
    rows = [_np(j_init_params(jcfg, jax.random.PRNGKey(i))) for i in range(2)]
    stacked = jax.tree.map(lambda *ls: np.stack(ls), *rows)
    jspec = JFlatSpec.for_tree(jax.tree.map(jnp.asarray, stacked))
    jbuf = jspec.ravel(jax.tree.map(jnp.asarray, stacked))
    tree = tree_from_numpy(stacked)
    spec = FlatSpec.for_tree(tree)
    buf = spec.ravel(tree)
    kw = dict(capacity=2, cache_len=16, prompt_len=6)
    jloop = JServeLoop(jcfg, jax.tree.map(jnp.asarray, rows[0]), **kw)
    jloop.reload_from_flat(jbuf, jspec, row=1)
    tloop = ServeLoop(params_from_jax(tcfg, rows[0]), **kw)
    tloop.reload_from_flat(buf, spec, row=1)
    assert torch.equal(tloop.model.layers[1].mlp["w_up"],
                       module_state(tcfg, tree_from_numpy(rows[1]))["layers.1.mlp.w_up"])
    prompts = [np.arange(1, 5), np.arange(7, 13)]
    for loop in (jloop, tloop):
        for p in prompts:
            loop.submit(p, max_new=5)
        loop.run()
    assert ({r.rid: r.tokens for r in tloop.completed}
            == {r.rid: r.tokens for r in jloop.completed})
