"""The port's checkpoints, token streams, round ledger export and
profiler hooks against the JAX reference on the CPU, and
``SlotTrainLoop.save`` / ``restore`` (the checks of
``tests/test_substrate.py``, ``tests/test_runtime.py`` and
``tests/test_faults.py``), with checkpoints crossing between the two
packages in both directions.  Each tolerance is stated where it is
used."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JCheckpointManager
from repro.ckpt.checkpoint import load as j_load
from repro.ckpt.checkpoint import save as j_save
from repro.core.ndmp import Simulator as JSimulator
from repro.data.tokens import TokenStream as JTokenStream
from repro.data.tokens import enc_frames_for as j_enc_frames_for
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import dfl_train_bundle
from repro.launch.train import tiny_lm as j_tiny_lm
from repro.models.config import INPUT_SHAPES
from repro.models.model import init_params as j_init_params
from repro.obs.rounds import RoundLedger as JRoundLedger
from repro.optim import optimizers as jopt
from repro.overlay.controller import OverlayController as JController
from repro.runtime.loop import SlotTrainLoop as JSlotTrainLoop
from repro_torch.ckpt.checkpoint import CheckpointManager, load, save, state_leaves
from repro_torch.configs import tiny_lm
from repro_torch.core.ndmp import Simulator
from repro_torch.data import TokenStream, enc_frames_for
from repro_torch.dist.flat import tree_flatten
from repro_torch.launch.steps import dfl_local_step
from repro_torch.models.convert import tree_from_numpy
from repro_torch.obs import RoundLedger, Telemetry, capture, disabled, scope, annotation
from repro_torch.obs.events import get_telemetry, telemetry
from repro_torch.obs.rounds import get_round_ledger, round_ledger
from repro_torch.optim import optimizers as topt
from repro_torch.overlay.controller import OverlayController
from repro_torch.runtime.loop import SlotTrainLoop
from repro_torch.runtime.masked import masked_local_step


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep each xdist worker's intra-op pool small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# --------------------------------------------------------------------------
# TokenStream
# --------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,batch,seq,seed,client",
                         [(512, 8, 128, 0, 0), (512, 8, 128, 0, 5), (97, 3, 17, 7, 2),
                          (128256, 1, 64, 1, 3)])
def test_token_stream_is_the_references(vocab, batch, seq, seed, client):
    """Five batches equal to the reference's, array for array (dtype
    too), and the enc-dec frame count the same."""
    got = list(TokenStream(vocab, batch, seq, seed=seed, client=client).batches(5))
    want = list(JTokenStream(vocab, batch, seq, seed=seed, client=client).batches(5))
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.int32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    assert enc_frames_for(None, seq * 40) == j_enc_frames_for(None, seq * 40)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _np_tree():
    """A tree of dicts, tuples and lists with f32, int32 and bf16 leaves
    (the bf16 leaf as its bits, a NaN and a subnormal among them)."""
    rng = np.random.default_rng(3)
    bf = rng.integers(0, 1 << 16, (4, 3)).astype(np.uint16)
    bf.flat[0], bf.flat[1] = 0x7FC1, 0x0001
    return {"a": rng.normal(size=(2, 3)).astype(np.float32),
            "b": {"c": bf, "d": (np.asarray(3, np.int32),
                                 rng.integers(-9, 9, (5,)).astype(np.int32))},
            "e": [np.zeros((2, 2), np.float32), np.float32(2.5)]}


def _bf16_bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _torch_tree(t):
    """_np_tree as tensors, the bf16 leaf as torch.bfloat16."""
    out = tree_from_numpy({k: v for k, v in t.items() if k != "b" and k != "e"})
    out["b"] = {"c": torch.from_numpy(t["b"]["c"].view(np.int16)).view(torch.bfloat16),
                "d": tuple(torch.from_numpy(np.asarray(x)) for x in t["b"]["d"])}
    out["e"] = [torch.from_numpy(np.asarray(x)) for x in t["e"]]
    return out


def _assert_same_leaves(got, want):
    """Leaf for leaf bit for bit, dtypes by name, structure kinds too."""
    g_leaves, g_def = tree_flatten(got)
    w_leaves = jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bf16_bits(g), _bf16_bits(w))
        else:
            assert str(g.numpy().dtype) == w.dtype.name
            np.testing.assert_array_equal(g.numpy(), w)
    assert isinstance(got["b"]["d"], tuple) and isinstance(got["e"], list)


def test_checkpoint_roundtrip_and_files_cross_packages(tmp_path):
    """The port's save → its load, the reference's save → the port's load
    and the port's save → the reference's load, bit for bit (bf16 as its
    bits), with the dtypes, the tuple and list kinds and the metadata;
    the files of both packages hold the same npz keys, dtypes and
    treedef."""
    nt = _np_tree()
    jt = jax.tree.map(jnp.asarray, nt)
    jt["b"]["c"] = jnp.asarray(nt["b"]["c"].view(jnp.bfloat16))
    tt = _torch_tree(nt)
    save(str(tmp_path / "port"), tt, {"step": 7})
    j_save(str(tmp_path / "ref"), jt, {"step": 7})
    got, meta = load(str(tmp_path / "port"))
    assert meta == {"step": 7}
    _assert_same_leaves(got, jt)
    got, meta = load(str(tmp_path / "ref"))
    assert meta == {"step": 7}
    _assert_same_leaves(got, jt)
    back, meta = j_load(str(tmp_path / "port"))
    assert meta == {"step": 7}
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jt)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(g).reshape(-1).view(np.uint8),
                                      np.asarray(w).reshape(-1).view(np.uint8))
    specs = [json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "ref")]
    assert specs[0] == specs[1]
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_of_card_or_numpy_leaves(tmp_path):
    """numpy leaves save as they are; load returns CPU tensors."""
    save(str(tmp_path / "n"), {"x": np.arange(3, dtype=np.float32)}, None)
    tree, meta = load(str(tmp_path / "n"))
    assert meta == {} and tree["x"].device.type == "cpu"
    assert tree["x"].tolist() == [0.0, 1.0, 2.0]


def test_checkpoint_manager_retention(tmp_path):
    """keep=2 over four saves keeps steps 3 and 4 (as the reference's
    does on the same saves); restore gives the newest, a named step, or
    FileNotFoundError on an empty directory."""
    mgr = CheckpointManager(str(tmp_path / "p"), keep=2)
    jmgr = JCheckpointManager(str(tmp_path / "j"), keep=2)
    assert mgr.latest() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.tensor(float(s))})
        jmgr.save(s, {"x": jnp.asarray(float(s))})
    assert mgr.steps() == jmgr.steps() == [3, 4]
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
    tree, meta = mgr.restore()
    assert float(tree["x"]) == 4.0 and meta["step"] == 4 and mgr.latest() == 4
    assert float(mgr.restore(3)[0]["x"]) == 3.0
    assert float(load(os.path.join(tmp_path, "j", "ckpt_00000003"))[0]["x"]) == 3.0


def test_state_leaves_are_the_references_order():
    """A training state's leaves in the order jax.tree.leaves gives the
    reference's: opt_state (AdamW as mu..., nu..., count), then params,
    then residual; SGD's momentum tree and () as they flatten."""
    p = {"b": np.full(2, 2.0, np.float32), "a": np.full(3, 1.0, np.float32)}
    for make in (lambda m: m.adamw(1e-3), lambda m: m.sgd(0.1, momentum=0.9),
                 lambda m: m.sgd(0.1)):
        jp = jax.tree.map(jnp.asarray, p)
        jo = make(jopt).init(jp)
        jo = jax.tree.map(lambda l: l + 5.0 if l.dtype == jnp.float32 else l, jo)
        want = jax.tree.leaves({"params": jp, "opt_state": jo,
                                "residual": jnp.zeros(4)})
        tp = tree_from_numpy(p)
        to = make(topt).init(tp)
        for leaf in tree_flatten(to)[0]:
            if leaf.dtype == torch.float32:
                leaf.add_(5.0)
        got = state_leaves({"params": tp, "opt_state": to, "residual": torch.zeros(4)})
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# SlotTrainLoop save / restore on the quadratic step (tests/test_runtime.py)
# --------------------------------------------------------------------------

DIM = 32


def _sim(cls, n, L=2):
    sim = cls(num_spaces=L, latency=0.05, heartbeat_period=0.5, probe_period=1.0,
              seed=0)
    sim.seed_network(list(range(n)))
    return sim


def _rows(node_ids, step):
    return np.stack([np.random.default_rng(abs(hash((u, step))) % 2**32)
                     .normal(size=DIM).astype(np.float32) for u in node_ids])


def _t_step(params, opt_state, batch):
    w, x = params["w"], batch["x"]
    loss = ((w - x) ** 2).mean(dim=-1)
    return {"w": w - 0.05 * 2.0 * (w - x) / DIM}, opt_state, {"loss": loss}


def _quad_loop(n=6, codec="int8-block", opt=None):
    ctl = OverlayController(_sim(Simulator, n), capacity=8, fuse="flat",
                            codec=codec, flat_io=True)
    return SlotTrainLoop(
        ctl, local_step=masked_local_step(_t_step),
        make_params=lambda u: {"w": torch.from_numpy(
            np.random.default_rng(u).normal(size=DIM).astype(np.float32))},
        optimizer=opt or topt.sgd(0.0),
        make_batch=lambda ids, s: {"x": torch.from_numpy(_rows(ids, s))})


def _ptrs(loop):
    return {loop.params.data_ptr(), loop._spare.data_ptr(), loop.residual.data_ptr(),
            *(t.data_ptr() for t in tree_flatten(loop.opt_state)[0])}


def test_slot_loop_checkpoint_roundtrip_bit_exact(tmp_path):
    """Save after 5 rounds under int8-block, rebuild the stack, replay
    the control plane, restore: population, residual and optimizer state
    bit for bit, copied into the fresh loop's resident buffers (their
    storage kept), the step counter and the occupancy metadata (two
    empty slots) restored; the next 3 rounds equal the uninterrupted
    loop's bit for bit."""
    opt = topt.sgd(0.0, momentum=0.9)
    loop = _quad_loop(opt=opt)
    loop.run(5)
    assert loop.ef and float(loop.residual.abs().max()) > 0
    path = str(tmp_path / "slot.npz")
    loop.save(path)
    fresh = _quad_loop(opt=opt)
    ptrs = _ptrs(fresh)
    for _ in range(5):
        fresh.controller.step(1.0)
        fresh.controller.commit()
    meta = fresh.restore(path)
    assert meta["step"] == 5 and fresh._step == 5
    assert meta["slots"].count(-1) == 2 and meta["ef"] and meta["flat_io"]
    assert _ptrs(fresh) == ptrs
    assert torch.equal(loop.params, fresh.params)
    assert torch.equal(loop.residual, fresh.residual)
    for a, b in zip(tree_flatten(loop.opt_state)[0], tree_flatten(fresh.opt_state)[0]):
        assert torch.equal(a, b)
    recs_a, recs_b = loop.run(3), fresh.run(3)
    assert torch.equal(loop.params, fresh.params)
    assert [r.loss for r in recs_a[-3:]] == [r.loss for r in recs_b[-3:]]


def test_slot_loop_restore_rejects_other_wire_and_occupancy(tmp_path):
    """A loop with another wire configuration, or another slot
    occupancy, refuses the checkpoint with the reference's words."""
    path = str(tmp_path / "s.npz")
    _quad_loop().save(path)
    with pytest.raises(ValueError, match="wire configuration"):
        _quad_loop(codec=None).restore(path)
    with pytest.raises(ValueError, match="occupancy"):
        _quad_loop(n=5).restore(path)


# --------------------------------------------------------------------------
# SlotTrainLoop checkpoints across the packages, on a small language model
# --------------------------------------------------------------------------

CAPACITY, SEQ, LIVE, FIRST, THEN = 4, 32, 3, 2, 2
LM_J_CFG, LM_CFG = j_tiny_lm(vocab=256, d_model=64, layers=1), \
    tiny_lm(vocab=256, d_model=64, layers=1)
OPTIMIZERS = {"sgd_momentum": lambda m: m.sgd(0.05, momentum=0.9),
              "adamw": lambda m: m.adamw(3e-3, weight_decay=0.0)}

_j_lm_init = jax.jit(lambda key: j_init_params(LM_J_CFG, key, dtype=jnp.float32))


@functools.lru_cache(maxsize=None)
def _lm_params(node_id):
    return _j_lm_init(jax.random.PRNGKey(node_id))


def _lm_rows(node_ids, step):
    return {k: np.stack([np.random.default_rng(abs(hash((u, step, k))) % 2**32)
                         .integers(0, LM_J_CFG.vocab_size, (1, SEQ)) for u in node_ids]
                        ).astype(np.int32) for k in ("tokens", "labels")}


def _j_loop(name, step):
    return JSlotTrainLoop(
        JController(_sim(JSimulator, LIVE), capacity=CAPACITY, fuse="flat",
                    flat_io=True),
        local_step=step, make_params=_lm_params, optimizer=OPTIMIZERS[name](jopt),
        jit_local_step=False,
        make_batch=lambda ids, s: {k: jnp.asarray(v) for k, v in _lm_rows(ids, s).items()})


def _t_loop(name):
    return SlotTrainLoop(
        OverlayController(_sim(Simulator, LIVE), capacity=CAPACITY, fuse="flat",
                          flat_io=True),
        local_step=dfl_local_step(LM_CFG, OPTIMIZERS[name](topt)),
        make_params=lambda u: tree_from_numpy(jax.tree.map(np.asarray, _lm_params(u))),
        optimizer=OPTIMIZERS[name](topt),
        make_batch=lambda ids, s: {k: torch.from_numpy(v) for k, v in _lm_rows(ids, s).items()})


def _replayed(loop, rounds):
    for _ in range(rounds):
        loop.controller.step(1.0)
        loop.controller.commit()
    return loop


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_slot_loop_checkpoints_cross_packages(tmp_path, name):
    """The reference's loop saves after 2 rounds and runs 2 more; the
    port's loop, its control plane replayed, restores that checkpoint and
    runs the same 2 rounds: per-round loss within 1e-4 relative and the
    population within 1e-5 x max|buf| (the loop's tolerances; one f32
    step a round through two autodiff systems).  The other way: the
    port's checkpoint after its own 2 rounds restores in the reference's
    loop, bit for bit, with the optimizer state in the reference's
    layout."""
    opt_j = OPTIMIZERS[name](jopt)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=CAPACITY,
                                seq_len=SEQ)
    bundle = dfl_train_bundle(LM_J_CFG, shape, make_local_mesh(1, 1), opt_j,
                              dtype=jnp.float32, sync="none", masked=True)
    step = jax.jit(bundle.step)
    jloop = _j_loop(name, step)
    jloop.run(FIRST)
    j_path = str(tmp_path / "ref.npz")
    jloop.save(j_path)
    jrec = jloop.run(THEN)[-THEN:]

    tloop = _replayed(_t_loop(name), FIRST)
    assert tloop.restore(j_path)["step"] == FIRST
    trec = tloop.run(THEN)[-THEN:]
    for a, b in zip(trec, jrec):
        assert abs(a.loss - b.loss) <= 1e-4 * abs(b.loss)
    jbuf = np.asarray(jloop.params)
    np.testing.assert_allclose(tloop.params.numpy(), jbuf, rtol=0,
                               atol=1e-5 * np.abs(jbuf).max())

    own = _t_loop(name)
    own.run(FIRST)
    t_path = str(tmp_path / "port.npz")
    own.save(t_path)
    back = _replayed(_j_loop(name, step), FIRST)
    assert back.restore(t_path)["step"] == FIRST
    np.testing.assert_array_equal(np.asarray(back.params), own.params.numpy())
    want = state_leaves({"params": own.params, "opt_state": own.opt_state})
    for g, w in zip(jax.tree.leaves({"params": back.params,
                                     "opt_state": back.opt_state}), want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


# --------------------------------------------------------------------------
# the round ledger's export and the profiler hooks
# --------------------------------------------------------------------------

ROUNDS = [dict(round=0, time=0.5, loop="train", num_alive=4, participating=4,
               loss=2.5, wire_bytes_per_client=100.0, payload_bytes_per_client=400.0,
               swapped=True, joined=(7,), repair_ms=1.25),
          dict(round=1, time=1.0, loop="train", num_alive=3, participating=2,
               loss=float("nan"), wire_bytes_per_client=100.0,
               payload_bytes_per_client=400.0, cache_hit=True, left=(2,),
               commit_ms=0.5)]


def test_ledger_export_matches_jax(tmp_path):
    """The same records through both ledgers: the training fields read as
    attributes with the reference's values, summary() equal but for the
    reference's retraces, the JSONL rows equal but for the reference's
    retrace and fault fields the port's loop did not set, and the table's
    rows the reference's without its retrace column."""
    jl, tl = JRoundLedger(bus=Telemetry()), RoundLedger(bus=Telemetry())
    for r in ROUNDS:
        jl.record(**r)
        tl.record(**r)
    for a, b in zip(tl.rows, jl.rows):
        for k in ("time", "loss", "wire_bytes_per_client", "swapped", "cache_hit",
                  "joined", "left", "repair_ms", "commit_ms", "degraded_edges",
                  "faults_injected", "rebuilt"):
            va, vb = getattr(a, k), getattr(b, k)
            assert va == vb or (va != va and vb != vb), k
    js = jl.summary()
    js.pop("retraces")
    assert tl.summary() == js
    tl.to_jsonl(tmp_path / "t.jsonl")
    jl.to_jsonl(tmp_path / "j.jsonl")
    t_rows = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text().splitlines()]
    j_rows = [json.loads(x) for x in (tmp_path / "j.jsonl").read_text().splitlines()]
    assert t_rows[1]["loss"] is None
    for t, j in zip(t_rows, j_rows):
        assert {k: j[k] for k in t} == t
    assert tl.rows_as_dicts()[0]["joined"] == (7,)
    table = tl.summary_table()
    assert "retr" not in table and "2.5000" in table and "+1" in table
    assert table.splitlines()[-1].startswith("rounds=2 swaps=1 cache_hits=1")
    assert RoundLedger().summary() == {"rounds": 0}


def test_disabled_and_profile_hooks(tmp_path):
    """disabled() forces the no-op bus and no ledger and restores both;
    scope and annotation label a block; capture(None) does nothing and
    capture(dir) writes a Chrome trace holding the labels."""
    bus = Telemetry()
    with telemetry(bus), round_ledger() as ledger:
        with disabled():
            assert not get_telemetry().enabled and get_round_ledger() is None
        assert get_telemetry() is bus and get_round_ledger() is ledger
    with capture(None):
        pass
    with capture(str(tmp_path / "prof")):
        with scope("fedlay_mix/round0"), annotation("train.step", step=3):
            torch.ones(8).sum()
    trace = (tmp_path / "prof" / "trace.json").read_text()
    assert "fedlay_mix/round0" in trace and "train.step#step=3#" in trace
