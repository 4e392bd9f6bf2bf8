"""The port's CNN and LSTM tasks against the JAX reference on the CPU:
the flat layout, ``evaluate``, ``init_params``, the label histograms,
``local_train``, the LSTM's batches, and ``Engine.run`` over both tasks
for Table III's five methods at ``benchmarks/common.py``'s cifar and
shakespeare sizes.  Both sides get the same numpy data and the
reference's initial vector (``task_params_from_jax``); each tolerance is
stated where it is used.  ``MLPTask`` is held in
``tests/test_torch_dfl.py``, and the engine on the card in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from repro.core import dfl as jdfl
from repro.data import noniid as jnoniid
from repro.data import synthetic as jsynth
from repro.models.small import CNNTask as JCNNTask
from repro.models.small import LSTMTask as JLSTMTask
from repro.models.small import _unflatten
from repro_torch.core import dfl
from repro_torch.core.dfl import Engine, resolve_method
from repro_torch.data import noniid, synthetic
from repro_torch.kernels.weighted_mix import weighted_mix
from repro_torch.models.convert import task_params_from_jax
from repro_torch.models.small import CNNTask, LSTMTask, MLPTask

#: Table III's columns (benchmarks/table3_accuracy.py:19)
METHODS = ("fedlay", "fedavg", "gaia", "chord", "dfl-dds")
#: local_train and final models, port against reference, as a share of
#: max|p|: the same numpy batches, f32 on both sides, but convolutions,
#: matmuls and their gradients round differently (2.6e-7 and 4.4e-8 of
#: max|p| read after 4 steps at the default widths); the reference's
#: engine aggregates in float64 and the port's in f32
TOL = 1e-5
KEYS = {"cnn": ["b", "b1", "b2", "c1", "c2", "w"],
        "lstm": ["b", "bo", "emb", "wh", "wo", "wx"]}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep each xdist worker's intra-op pool small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cnn_pair(**kw):
    """``benchmarks/common.py:cifar_task`` on both sides, from the same
    data, with the reference's initial vector."""
    data = synthetic.cifar_like(n_train=800, n_test=300, image=8, seed=0)
    part = noniid.shard_partition(data.y_train, 10, 3, seed=0)
    jdata = jsynth.cifar_like(n_train=800, n_test=300, image=8, seed=0)
    jpart = jnoniid.shard_partition(jdata.y_train, 10, 3, seed=0)
    kw = dict(channels=8, local_steps=2, batch=32, **kw)
    jtask = JCNNTask(jdata, jpart, **kw)
    return CNNTask(data, part, device="cpu", **kw), jtask, jtask.init_params(0)


def _lstm_pair(**kw):
    """``benchmarks/common.py:shakespeare_task`` on both sides."""
    data = synthetic.char_lm(num_roles=24, stream_len=512, test_len=2048, seed=0)
    jdata = jsynth.char_lm(num_roles=24, stream_len=512, test_len=2048, seed=0)
    kw = dict(hidden=32, seq=24, local_steps=2, batch=8, **kw)
    jtask = JLSTMTask(jdata, 8, **kw)
    return LSTMTask(data, 8, device="cpu", **kw), jtask, jtask.init_params(0)


@pytest.fixture(scope="module")
def pairs():
    """One task pair of each kind for the whole file: JAX compiles each
    task's step and accuracy once per instance."""
    return {"cnn": _cnn_pair(), "lstm": _lstm_pair()}


def _n_predictions(task):
    if isinstance(task, LSTMTask):
        return task._yte.numel()
    return len(task.data.y_test)


# --------------------------------------------------------------------------
# layout, init, evaluate, histograms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cnn", "lstm"])
def test_layout_and_evaluate(pairs, kind):
    """The flat layout is the reference's (keys sorted by name): each leaf
    is the reference's unflattened leaf, and ``evaluate`` counts the
    reference's correct predictions exactly, at the initial vector and a
    perturbed one."""
    task, jtask, flat = pairs[kind]
    vec = task_params_from_jax(flat, task=task)
    assert vec.dtype == torch.float32 and vec.numel() == task.num_params == flat.size
    assert [name for name, _, _ in task._layout] == KEYS[kind]
    tree, jtree = task.unflatten(vec), _unflatten(flat, jtask._spec)
    assert sorted(jtree) == KEYS[kind]
    for name, leaf in tree.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jtree[name]))
    rng = np.random.default_rng(9)
    n = _n_predictions(task)
    for p in (flat, (flat + 0.3 * rng.normal(size=flat.size)).astype(np.float32)):
        assert round(task.evaluate(task_params_from_jax(p)) * n) == round(jtask.evaluate(p) * n)


@pytest.mark.parametrize("kind", ["cnn", "lstm"])
def test_init_histograms_and_cost(pairs, kind):
    """``init_params`` is deterministic per seed, has zero biases and the
    reference's leaf scales within sampling error; ``label_histogram`` and
    ``train_cost`` are the reference's for every client."""
    task, jtask, flat = pairs[kind]
    init = task.init_params(3)
    assert init.shape == (task.num_params,) and init.dtype == torch.float32
    assert torch.equal(init, task.init_params(3)) and not torch.equal(init, task.init_params(4))
    tree, jtree = task.unflatten(init), _unflatten(flat, jtask._spec)
    for name, leaf in tree.items():
        want = np.asarray(jtree[name])
        if name.startswith("b"):
            assert torch.equal(leaf, torch.zeros_like(leaf)), name
        else:
            assert abs(leaf.std().item() / want.std() - 1) < 0.25, name
    for c in range(task.num_clients):
        np.testing.assert_array_equal(task.label_histogram(c), jtask.label_histogram(c))
        assert task.train_cost(c) == jtask.train_cost(c)


def test_default_widths():
    """At the paper's input widths and the tasks' defaults the flat
    vectors are as long as the reference's: N = 25,578 for the CNN on
    32 x 32 x 3 images, 27,936 for the LSTM at vocab 32."""
    data = synthetic.cifar_like(n_train=40, n_test=10, image=32, seed=0)
    part = noniid.shard_partition(data.y_train, 4, 2, seed=0)
    jdata = jsynth.cifar_like(n_train=40, n_test=10, image=32, seed=0)
    jpart = jnoniid.shard_partition(jdata.y_train, 4, 2, seed=0)
    cnn = CNNTask(data, part, device="cpu")
    assert cnn.num_params == JCNNTask(jdata, jpart).init_params(0).size == 25_578
    text = synthetic.char_lm(num_roles=4, stream_len=64, test_len=64, seed=0)
    jtext = jsynth.char_lm(num_roles=4, stream_len=64, test_len=64, seed=0)
    lstm = LSTMTask(text, 2, device="cpu")
    assert lstm.num_params == JLSTMTask(jtext, 2).init_params(0).size == 27_936
    assert (cnn.lr, cnn.batch, cnn.local_steps, cnn.ch) == (0.05, 32, 4, 16)
    assert (lstm.lr, lstm.batch, lstm.local_steps, lstm.hidden, lstm.seq) == (
        0.5, 16, 4, 64, 32)


def test_task_params_from_jax_checks_the_length(pairs):
    """With a task, a vector of the wrong length raises; without, it is
    carried over as it is."""
    for task, _, flat in pairs.values():
        with pytest.raises(ValueError, match=f"{task.num_params} parameters"):
            task_params_from_jax(flat[:-1], task=task)
        assert task_params_from_jax(flat[:-1]).numel() == flat.size - 1
    mlp_data = synthetic.mnist_like(n_train=40, n_test=10, seed=0)
    mlp = MLPTask(mlp_data, noniid.iid_partition(mlp_data.y_train, 2, seed=0),
                  hidden=4, device="cpu")
    with pytest.raises(ValueError, match="MLPTask"):
        task_params_from_jax(np.zeros(mlp.num_params + 1), task=mlp)


# --------------------------------------------------------------------------
# local_train and the LSTM's batches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("client,seed", [(0, 0), (3, 7), (7, 123456)])
@pytest.mark.parametrize("kind", ["cnn", "lstm"])
def test_local_train_matches(pairs, kind, client, seed):
    """One ``local_train`` from the same vector with the same seed is
    within TOL of max|p| of the reference's, and leaves its input
    unchanged."""
    task, jtask, flat = pairs[kind]
    vec = task_params_from_jax(flat)
    got = task.local_train(vec, client, seed=seed)
    want = jtask.local_train(flat, client, seed=seed)
    assert torch.equal(vec, task_params_from_jax(flat))
    assert got.dtype == torch.float32 and got.shape == vec.shape
    assert not torch.equal(got, vec)
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()


def test_lstm_batches_are_the_reference(pairs):
    """``_batch_of`` gives the reference's (x, y) for each client's roles,
    y is x shifted by one character, and, its RNG being seeded by the
    roles alone, a client draws the same window offsets at every step and
    the same batch whenever ``take`` lists its roles in the same order."""
    task, jtask, _ = pairs["lstm"]
    for client in range(task.num_clients):
        idx = task.partition.client_indices[client]
        takes = [np.random.default_rng(s).choice(idx, size=min(task.batch, len(idx)),
                                                 replace=False) for s in range(4)]
        batches = [task._batch_of(take) for take in takes]
        for take, (x, y) in zip(takes, batches):
            jx, jy = jtask._batch_of(take)
            assert x.shape == y.shape == (task.batch, task.seq)
            np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
            assert torch.equal(x[:, 1:], y[:, :-1])
        for take, (x, _) in zip(takes, batches):
            if list(take) == list(takes[0]):
                assert torch.equal(x, batches[0][0])


# --------------------------------------------------------------------------
# Engine.run
# --------------------------------------------------------------------------

def _run_both(pair, method, monkeypatch):
    """Engine.run on both sides from the reference's initial vector,
    counting the port's weighted_mix calls."""
    task, jtask, flat = pair
    vec = task_params_from_jax(flat, task=task)
    kw = dict(total_time=4.0, model_bytes=1000, seed=0)
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return weighted_mix(*args, **kwargs)
    monkeypatch.setattr(dfl, "weighted_mix", counted)
    if resolve_method(method).engine == "gossip":
        got = Engine().run(task, method, init_params=[vec] * task.num_clients, **kw)
        want = jdfl.Engine().run(jtask, method, init_params=[flat] * task.num_clients, **kw)
    else:
        monkeypatch.setattr(task, "init_params", lambda seed: vec.clone())
        monkeypatch.setattr(jtask, "init_params", lambda seed: flat.copy())
        got = Engine().run(task, method, **kw)
        want = jdfl.Engine().run(jtask, method, **kw)
    return got, want, calls


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", ["cnn", "lstm"])
def test_engine_run_matches(pairs, kind, method, monkeypatch):
    """Counters and trace times equal; every trace accuracy within
    2 / (number of predictions); final models within TOL of max|p|; one
    weighted_mix call per aggregation, as the engine counts them."""
    task = pairs[kind][0]
    got, want, calls = _run_both(pairs[kind], method, monkeypatch)
    assert got.method == want.method
    for field in ("comm_bytes_per_client", "messages_per_client", "suppressed_sends",
                  "local_steps_per_client"):
        assert getattr(got, field) == getattr(want, field), field
    assert [r.time for r in got.trace] == [r.time for r in want.trace]
    n = _n_predictions(task)
    for r, s in zip(got.trace, want.trace):
        assert np.abs(r.accs - s.accs).max() <= 2 / n
        assert abs(r.mean_acc - s.mean_acc) <= 2 / n
    assert len(got.final_params) == len(want.final_params) == task.num_clients
    scale = max(np.abs(np.asarray(p)).max() for p in want.final_params)
    for p, q in zip(got.final_params, want.final_params):
        assert p.dtype == torch.float32 and p.shape == (task.num_params,)
        assert np.abs(p.double().numpy() - np.asarray(q, np.float64)).max() <= TOL * scale
    assert got.aggregations == len(calls) > 0
    assert {shape[1] for shape in calls} == {task.num_params}


@pytest.mark.parametrize("N,vec", [(25_578, 2), (27_936, 4)])
def test_engine_rows_load_width(N, vec):
    """At the tasks' default N, with 100 clients at L = 3 (1 + D = 7),
    the CUDA weighted_mix's launch plan for a wake-up over client u's
    rows of the engine's (n, 1 + D, N) buffer, written into its row 0:
    8-byte loads for the CNN, whose rows sit 8 bytes off the 16-byte
    grid, 16-byte loads for the LSTM, whose rows lie on it."""
    from repro_torch.kernels.weighted_mix import launch_plan
    base = 0x7f0000000000
    for u in (0, 1, 37, 99):
        addr = base + u * 7 * N * 4
        assert launch_plan(7, N, 4, N, addr, addr, 132, True).vec == vec
