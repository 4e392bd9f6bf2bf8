"""The port's DFL engine slice against the JAX reference on the CPU:
``weighted_mix``'s plain path against the Pallas kernel in interpret mode
and the jnp oracle, the data copies, the baseline overlays and their
metrics, the MEP and mixing host pieces, ``MLPTask``, and ``Engine.run``
for seven methods.  Same numpy inputs and the same initial flat vectors
(``task_params_from_jax``) on both sides; each tolerance is stated where
it is used.  The CUDA ``weighted_mix`` and the engine on the card are
held to these plain paths in ``tests/test_torch_cuda.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import dfl as jdfl
from repro.core import mep as jmep
from repro.core import metrics as jmetrics
from repro.core import mixing as jmixing
from repro.data import noniid as jnoniid
from repro.data import synthetic as jsynth
from repro.kernels.ops import weighted_mix as jax_weighted_mix
from repro.kernels.ref import weighted_mix_ref as jax_weighted_mix_ref
from repro.models.small import MLPTask as JMLPTask
from repro_torch.core import baselines, dfl, mep, metrics, mixing
from repro_torch.core.dfl import (METHOD_REGISTRY, Engine, MethodSpec, RunResult,
                                  resolve_method, run_gossip)
from repro_torch.data import noniid, synthetic
from repro_torch.kernels.ref import weighted_mix_ref
from repro_torch.kernels.weighted_mix import (BLOCK_SIZES, MAX_BY_VALUE, THREADS_PER_SM,
                                              launch_plan, weighted_mix)
from repro_torch.models.convert import task_params_from_jax
from repro_torch.models.small import MLPTask

# the reference sweep's own shapes and tolerances (tests/test_kernels.py)
TOLS = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MIX_SHAPES = [(1, 128, 128), (3, 1000, 256), (7, 4096, 1024), (13, 65536, 65536),
              (5, 131, 128), (3, 200, 65536), (5, 300, 512)]
#: Engine.run's methods held to the reference: FedLay, its two ablations,
#: and Table III's baselines (benchmarks/table3_accuracy.py:19)
METHODS = ("fedlay", "fedlay-noconf", "fedlay-sync", "fedavg", "gaia", "chord",
           "dfl-dds")
#: final models, port against reference, as a share of max|p|: the
#: reference aggregates in float64 and the port in f32 (≈ 2e-7 read),
#: with SGD steps in between
ENGINE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep each xdist worker's intra-op pool small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(t):
    return t.float().numpy()


# --------------------------------------------------------------------------
# weighted_mix: the plain path against the Pallas kernel and the oracle
# --------------------------------------------------------------------------

def _mask(kind, K, rng):
    if kind is None:
        return None
    if kind == "all":
        return np.zeros(K, np.float32)
    m = (rng.random(K) < 0.5).astype(np.float32)
    m[0] = 1.0
    return m


@pytest.mark.parametrize("mask_kind", [None, "some", "all"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N,bn", MIX_SHAPES)
def test_weighted_mix_matches_jax(K, N, bn, dtype, mask_kind):
    """The port's plain path (CPU tensors) against the Pallas kernel in
    interpret mode and against ``weighted_mix_ref``, both JAX, at the
    reference sweep's tolerances (f32 2e-5, bf16 2e-2); an all-masked
    stack is exactly zero on both sides."""
    rng = np.random.default_rng(K * 7919 + N)
    m = rng.normal(size=(K, N)).astype(np.float32)
    w = rng.random(K).astype(np.float32)
    w /= w.sum()
    mask = _mask(mask_kind, K, rng)
    tdt = getattr(torch, dtype)
    got = weighted_mix(torch.from_numpy(m).to(tdt), torch.from_numpy(w),
                       mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == tdt and got.shape == (N,)
    jm = jnp.asarray(m, getattr(jnp, dtype))
    jmask = None if mask is None else jnp.asarray(mask)
    kern = jax_weighted_mix(jm, jnp.asarray(w), mask=jmask, block_n=bn, interpret=True)
    oracle = jax_weighted_mix_ref(jm, jnp.asarray(w), mask=jmask)
    for ref in (kern, oracle):
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), **TOLS[dtype])
    if mask_kind == "all":
        assert torch.equal(got.float(), torch.zeros(N))


def test_weighted_mix_identity_and_constant_stack():
    """Self weight 1 and the rest 0 gives the own row exactly; a masked
    constant stack keeps its value (the surviving weights sum to 1)."""
    rng = np.random.default_rng(0)
    m = torch.from_numpy(rng.normal(size=(4, 300)).astype(np.float32))
    assert torch.equal(weighted_mix(m, torch.tensor([1.0, 0.0, 0.0, 0.0])), m[0])
    w = torch.from_numpy(rng.random(5).astype(np.float32) + 0.1)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0])
    out = weighted_mix(torch.full((5, 256), 3.25), w, mask=mask)
    np.testing.assert_allclose(out.numpy(), 3.25, rtol=1e-6)


def test_weighted_mix_reads_strided_rows_and_writes_a_row():
    """A row-strided (K, N) view is read in place and ``out`` may be one
    of its rows; the result is the contiguous copy's, bit for bit."""
    rng = np.random.default_rng(1)
    big = torch.from_numpy(rng.normal(size=(9, 3, 257)).astype(np.float32))
    view = big[:, 1]                      # row stride 3·257
    w = torch.from_numpy(rng.random(9).astype(np.float32))
    want = weighted_mix_ref(view.contiguous(), w)
    out = weighted_mix(view, w, out=view[4])
    assert out.data_ptr() == big[4, 1].data_ptr()
    assert torch.equal(big[4, 1], want)


def test_weighted_mix_ref_sums_in_kernel_order():
    """The plain version sums from zero in the order k = 0 … K−1, each
    product rounded to f32 and then added: the CUDA kernel's order and
    rounding (so the card check is bit for bit)."""
    rng = np.random.default_rng(2)
    m = rng.normal(size=(6, 513)).astype(np.float32)
    w = rng.random(6).astype(np.float32)
    acc = np.zeros(513, np.float32)
    for k in range(6):
        acc = (acc + (w[k] * m[k]).astype(np.float32)).astype(np.float32)
    got = weighted_mix_ref(torch.from_numpy(m), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), acc)


def test_weighted_mix_rejects_bad_inputs():
    m = torch.zeros(3, 10)
    with pytest.raises(ValueError, match="weights must be"):
        weighted_mix(m, torch.ones(2))
    with pytest.raises(ValueError, match="mask must be"):
        weighted_mix(m, torch.ones(3), mask=torch.ones(4))
    with pytest.raises(ValueError, match="out must be"):
        weighted_mix(m, torch.ones(3), out=torch.zeros(11))
    with pytest.raises(ValueError, match="out must be"):
        weighted_mix(m, torch.ones(3), out=torch.zeros(10, 2)[:, 0])
    with pytest.raises(ValueError, match="takes \\(K, N\\)"):
        weighted_mix(torch.zeros(10), torch.ones(10))
    with pytest.raises(ValueError, match="mask on meta"):
        weighted_mix(m, torch.ones(3), mask=torch.ones(3, device="meta"))


def test_weighted_mix_device_rules():
    """Weights lie on the host or the models' device, and a mask on the
    weights' device; host weights with a host mask are the plain path's
    bits."""
    m = torch.zeros(3, 10)
    with pytest.raises(ValueError, match="weights on meta, models on cpu"):
        weighted_mix(m, torch.ones(3, device="meta"))
    with pytest.raises(ValueError, match="mask on meta, weights on cpu"):
        weighted_mix(m, torch.ones(3), mask=torch.ones(3, device="meta"))
    rng = np.random.default_rng(3)
    models = torch.from_numpy(rng.normal(size=(5, 77)).astype(np.float32))
    w = torch.from_numpy(rng.random(5).astype(np.float32))
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0])
    assert torch.equal(weighted_mix(models, w, mask=mask),
                       weighted_mix_ref(models, w, mask))


def test_masked_weights_total_is_order_free():
    """The renormalizing total is summed in f64 and rounded once, so it
    does not depend on the order of the reduction: reversed and shuffled
    weights give the same total, and so the same bits, as the original."""
    from repro_torch.kernels.ref import masked_weights
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.random(100).astype(np.float32))
    mask = torch.from_numpy((rng.random(100) < 0.5).astype(np.float32))
    got = masked_weights(w, mask)
    for order in (torch.arange(99, -1, -1), torch.from_numpy(rng.permutation(100))):
        assert torch.equal(masked_weights(w[order], mask[order]), got[order])
    eff = w * mask
    assert torch.equal(got, eff / eff.double().sum().float())


#: the DFL engine's row stride: rows of N f32, 8 bytes off the 16-byte grid
ENGINE_N = 50_890
H100_SMS = 132


def _covered(plan, N):
    """Elements written by the kernel's index walk under ``plan`` (its
    grid-stride loop over VEC-wide groups, then the scalar tail)."""
    hits = np.zeros(N, np.int64)
    stride, groups = plan.blocks * plan.threads, N // plan.vec
    for t in range(stride):
        for g in range(t, groups, stride):
            hits[g * plan.vec:(g + 1) * plan.vec] += 1
        if plan.vec > 1:
            hits[groups * plan.vec + t::stride] += 1
    return hits


@pytest.mark.parametrize("case,K,N,itemsize,stride,base,out,host,want", [
    # (vec, threads, blocks, by_value)
    ("wake-up", 7, ENGINE_N, 4, ENGINE_N, 0x7f0000000000, 0x7f0000100000, True,
     (2, 128, 199, True)),
    ("wake-up, device weights", 7, ENGINE_N, 4, ENGINE_N, 0x7f0000000000,
     0x7f0000100000, False, (2, 128, 199, False)),
    ("chord", 15, ENGINE_N, 4, ENGINE_N, 0x7f0000000000, 0x7f0000100000, True,
     (2, 128, 199, True)),
    ("fedavg", 100, ENGINE_N, 4, ENGINE_N, 0x7f0000000000, 0x7f0000100000, True,
     (2, 128, 199, True)),
    ("over the by-value struct", MAX_BY_VALUE + 1, ENGINE_N, 4, ENGINE_N,
     0x7f0000000000, 0x7f0000100000, True, (2, 128, 199, False)),
    ("padded rows", 7, ENGINE_N, 4, ENGINE_N + 2, 0x7f0000000000, 0x7f0000100000, True,
     (4, 64, 199, True)),
    ("bandwidth", 7, 2 ** 26, 4, 2 ** 26, 0x7f0000000000, 0x7f4000000000, True,
     (4, 256, H100_SMS * THREADS_PER_SM // 256, True)),
    ("odd f32 stride", 7, ENGINE_N, 4, ENGINE_N + 1, 0x7f0000000000, 0x7f0000100000,
     True, (1, 256, 199, True)),
    ("out 4 bytes off", 7, ENGINE_N, 4, ENGINE_N + 2, 0x7f0000000000, 0x7f0000100004,
     True, (1, 256, 199, True)),
    ("bf16 aligned", 7, ENGINE_N, 2, ENGINE_N + 6, 0x7f0000000000, 0x7f0000100000, True,
     (8, 32, 199, True)),
    ("bf16 8 bytes off", 7, ENGINE_N, 2, ENGINE_N + 2, 0x7f0000000000, 0x7f0000100000,
     True, (4, 64, 199, True)),
    ("bf16 4 bytes off", 7, ENGINE_N, 2, ENGINE_N, 0x7f0000000000, 0x7f0000100000, True,
     (2, 128, 199, True)),
    ("bf16 2 bytes off", 7, ENGINE_N, 2, ENGINE_N + 1, 0x7f0000000000, 0x7f0000100000,
     True, (1, 256, 199, True)),
    ("one row, odd stride", 1, ENGINE_N, 4, 3, 0x7f0000000000, 0x7f0000100000, True,
     (4, 64, 199, True)),
    ("one element", 3, 1, 4, 1, 0x7f0000000000, 0x7f0000100000, True,
     (1, 32, 1, True)),
])
def test_weighted_mix_launch_plan(case, K, N, itemsize, stride, base, out, host, want):
    """The launch plan at the engine's shapes (H100, 132 SMs): the widest
    load the base, row stride and output allow (8 bytes at the engine's
    f32 rows), a block on every SM at the wake-up, the grid-stride cap at
    N 2^26, host weights by value up to MAX_BY_VALUE."""
    plan = launch_plan(K, N, itemsize, stride, base, out, H100_SMS, host)
    assert (plan.vec, plan.threads, plan.blocks, plan.by_value) == want, case


@pytest.mark.parametrize("itemsize", [4, 2])
def test_weighted_mix_launch_plan_covers_every_element(itemsize):
    """Over ragged N, strides and addresses: the load width divides the
    base, the output and the row stride's bytes and is at most 16 bytes,
    the block is one of BLOCK_SIZES, the grid is at least one block an SM
    whenever the smallest block allows it, and the kernel's index walk
    writes every element exactly once."""
    rng = np.random.default_rng(itemsize)
    for _ in range(60):
        K = int(rng.integers(1, 40))
        N = int(rng.integers(1, 6000))
        stride = N + int(rng.integers(0, 9))
        base = 0x7f0000000000 + itemsize * int(rng.integers(0, 8))
        out = 0x7f1000000000 + itemsize * int(rng.integers(0, 8))
        sms = int(rng.integers(1, 40))
        plan = launch_plan(K, N, itemsize, stride, base, out, sms, bool(rng.integers(2)))
        width = plan.vec * itemsize
        assert width <= 16 and base % width == 0 and out % width == 0
        assert K == 1 or stride * itemsize % width == 0
        assert plan.threads in BLOCK_SIZES
        loads = -(-N // plan.vec)
        assert plan.blocks >= min(sms, -(-loads // BLOCK_SIZES[-1]))
        assert plan.blocks * plan.threads <= max(sms * THREADS_PER_SM, plan.threads)
        assert (_covered(plan, N) == 1).all()


# --------------------------------------------------------------------------
# data: bit-equal copies
# --------------------------------------------------------------------------

def _assert_same(a, b):
    for field in a.__dataclass_fields__:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), field
        else:
            assert x == y, field


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_data_is_bit_equal(seed):
    """Each generator and partition of ``repro_torch.data`` gives the
    reference's arrays exactly for the same seed."""
    _assert_same(synthetic.mnist_like(300, 50, seed=seed),
                 jsynth.mnist_like(300, 50, seed=seed))
    _assert_same(synthetic.mnist_like(100, 20, image=28, seed=seed),
                 jsynth.mnist_like(100, 20, image=28, seed=seed))
    _assert_same(synthetic.cifar_like(60, 20, seed=seed),
                 jsynth.cifar_like(60, 20, seed=seed))
    _assert_same(synthetic.char_lm(num_roles=4, stream_len=48, test_len=64, seed=seed),
                 jsynth.char_lm(num_roles=4, stream_len=48, test_len=64, seed=seed))
    for (x, y), (jx, jy) in zip(synthetic.token_batches(50, 2, 8, 3, seed=seed),
                                jsynth.token_batches(50, 2, 8, 3, seed=seed)):
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
    labels = jsynth.mnist_like(600, 10, seed=seed).y_train
    for got, want in [
            (noniid.shard_partition(labels, 20, 3, seed=seed),
             jnoniid.shard_partition(labels, 20, 3, seed=seed)),
            (noniid.shard_partition(labels, 20, 3, seed=seed, allow_overlap=True),
             jnoniid.shard_partition(labels, 20, 3, seed=seed, allow_overlap=True)),
            (noniid.biased_locality_partition(labels, 20, samples_per_label=30, seed=seed),
             jnoniid.biased_locality_partition(labels, 20, samples_per_label=30,
                                               seed=seed)),
            (noniid.iid_partition(labels, 7, seed=seed),
             jnoniid.iid_partition(labels, 7, seed=seed))]:
        assert got.num_classes == want.num_classes
        assert len(got.client_indices) == len(want.client_indices)
        for a, b in zip(got.client_indices, want.client_indices):
            assert np.array_equal(a, b)
        np.testing.assert_array_equal(got.label_histogram(labels, 3),
                                      want.label_histogram(labels, 3))


# --------------------------------------------------------------------------
# baselines, metrics, MEP and mixing host pieces
# --------------------------------------------------------------------------

def _build(registry, name, n):
    return registry[name](n, 3) if name == "fedlay" else registry[name](n)


@pytest.mark.parametrize("n", [5, 16, 37])
@pytest.mark.parametrize("name", list(baselines.TOPOLOGY_REGISTRY))
def test_topology_registry_matches(name, n):
    """Every registered overlay has the reference's nodes, edges and name,
    the Topology API agrees, and ``evaluate_topology`` is within 1e-12."""
    assert list(baselines.TOPOLOGY_REGISTRY) == list(jbase.TOPOLOGY_REGISTRY)
    got = _build(baselines.TOPOLOGY_REGISTRY, name, n)
    want = _build(jbase.TOPOLOGY_REGISTRY, name, n)
    assert (got.nodes, got.edges, got.name) == (want.nodes, want.edges, want.name)
    assert got.n == want.n and got.degrees() == want.degrees()
    assert got.neighbors(1) == want.neighbors(1)
    assert got.is_connected() == want.is_connected()
    np.testing.assert_array_equal(got.adjacency(), want.adjacency())
    a, b = metrics.evaluate_topology(got), jmetrics.evaluate_topology(want)
    for field in a.__dataclass_fields__:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, float) and np.isfinite(y):
            assert abs(x - y) <= 1e-12, field
        else:
            assert x == y, field


def test_random_regular_best_of_and_metrics_match():
    """The random d-regular sampler, the paper's "Best of" search, the
    mixing matrices and the metric helpers, against the reference."""
    for seed in (0, 3):
        got = baselines.random_regular(20, 4, rng=np.random.default_rng(seed))
        want = jbase.random_regular(20, 4, rng=np.random.default_rng(seed))
        assert got.edges == want.edges and got.name == want.name
    got, want = baselines.best_of_rrgs(16, 3, trials=4), jbase.best_of_rrgs(16, 3, trials=4)
    assert (got.edges, got.name) == (want.edges, want.name)
    topo = baselines.chord(12)
    A = topo.adjacency()
    for fn in ("metropolis_hastings_matrix", "uniform_mixing_matrix"):
        np.testing.assert_array_equal(getattr(metrics, fn)(A), getattr(jmetrics, fn)(A))
    assert metrics.convergence_factor(topo) == jmetrics.convergence_factor(topo)
    assert (metrics.convergence_factor(topo, "uniform")
            == jmetrics.convergence_factor(topo, "uniform"))
    assert (dataclasses.astuple(metrics.shortest_path_stats(topo))
            == dataclasses.astuple(jmetrics.shortest_path_stats(topo)))
    for lam in (0.0, 0.3, 0.9, 1.0):
        assert metrics.generalization_gap_bound(lam) == jmetrics.generalization_gap_bound(lam)
    with pytest.raises(ValueError):
        baselines.random_regular(5, 3)


@pytest.mark.parametrize("confidence", [True, False])
def test_confidence_mixing_matrix_and_gossip_step_match(confidence):
    """The simulation-path matrix over FedLay's overlay with the paper's
    3-tier periods and non-iid histograms is the reference's exactly."""
    rng = np.random.default_rng(4)
    n = 12
    periods = dfl.capacity_periods(n, 1.0, seed=2)
    np.testing.assert_array_equal(periods, jdfl.capacity_periods(n, 1.0, seed=2))
    hists = rng.integers(0, 20, size=(n, 10)).astype(np.float64)
    prof = {i: mep.ClientProfile(i, float(periods[i]), hists[i]) for i in range(n)}
    jprof = {i: jmep.ClientProfile(i, float(periods[i]), hists[i]) for i in range(n)}
    W = mixing.confidence_mixing_matrix(baselines.fedlay(n, 3), prof,
                                        confidence_weighted=confidence)
    JW = jmixing.confidence_mixing_matrix(jbase.fedlay(n, 3), jprof,
                                          confidence_weighted=confidence)
    np.testing.assert_array_equal(W, JW)
    np.testing.assert_allclose(W.sum(axis=1), 1.0, rtol=1e-12)
    X = rng.normal(size=(n, 33))
    np.testing.assert_array_equal(mixing.gossip_step(X, W), jmixing.gossip_step(X, JW))


def test_mep_host_pieces_match():
    """Fingerprints (a numpy vector, its tensor and a float64 copy), link
    and tier periods, confidences and the fingerprint table behave as the
    reference's."""
    rng = np.random.default_rng(5)
    flat = rng.normal(size=1001).astype(np.float32)
    fp = jmep.model_fingerprint(flat)
    assert mep.model_fingerprint(flat) == fp
    assert mep.model_fingerprint(torch.from_numpy(flat)) == fp
    assert mep.model_fingerprint(flat.astype(np.float64)) == fp
    assert mep.model_fingerprint(flat + np.float32(1e-3)) != fp
    for a, b in [(1.0, 2.0), (2.0 / 3.0, 1.0), (2.0, 2.0)]:
        assert mep.link_period(a, b) == jmep.link_period(a, b)
        assert mep.communication_confidence(a) == jmep.communication_confidence(a)
    for tier in ("high", "medium", "low"):
        assert mep.tier_period(1.5, tier) == jmep.tier_period(1.5, tier)
    assert mep.fine_grained_period(2.0) == jmep.fine_grained_period(2.0)
    with pytest.raises(ValueError):
        mep.fine_grained_period(1.0, eta=1.0)
    assert mep.DEVICE_PRESETS == jmep.DEVICE_PRESETS
    table, jtable = mep.FingerprintTable(), jmep.FingerprintTable()
    for t in (table, jtable):
        assert t.should_send(3, 11)
        t.record(3, 11)
        assert not t.should_send(3, 11)
        t.forget(3)
        assert t.should_send(3, 11)
    assert (table.sent, table.suppressed) == (jtable.sent, jtable.suppressed) == (2, 1)


# --------------------------------------------------------------------------
# MLPTask
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tasks():
    """tests/test_methods.py:20-26's small task on both sides, from the
    same data, with the reference's initial vector."""
    data = synthetic.mnist_like(n_train=240, n_test=120, seed=0)
    part = noniid.shard_partition(data.y_train, num_clients=8, shards_per_client=3,
                                  seed=0)
    jdata = jsynth.mnist_like(n_train=240, n_test=120, seed=0)
    jpart = jnoniid.shard_partition(jdata.y_train, num_clients=8,
                                    shards_per_client=3, seed=0)
    jtask = JMLPTask(jdata, jpart, hidden=8, local_steps=1, batch=16)
    task = MLPTask(data, part, hidden=8, local_steps=1, batch=16, device="cpu")
    flat = jtask.init_params(0)
    return task, jtask, flat


def test_mlp_task_layout_and_evaluate(tasks):
    """The flat layout is the reference's (b1, b2, w1, w2; w1 as
    (d_in, hidden)): each leaf is the reference's unflattened leaf, and
    ``evaluate`` counts the reference's correct predictions exactly."""
    from repro.models.small import _unflatten
    task, jtask, flat = tasks
    vec = task_params_from_jax(flat)
    assert vec.dtype == torch.float32 and vec.numel() == task.num_params == flat.size
    tree, jtree = task.unflatten(vec), _unflatten(flat, jtask._spec)
    assert [name for name, _, _ in task._layout] == ["b1", "b2", "w1", "w2"]
    for name, leaf in tree.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jtree[name]))
    rng = np.random.default_rng(9)
    for p in (flat, (flat + rng.normal(size=flat.size)).astype(np.float32)):
        n_test = len(task.data.y_test)
        assert (round(task.evaluate(task_params_from_jax(p)) * n_test)
                == round(jtask.evaluate(p) * n_test))
    init = task.init_params(3)
    assert init.shape == vec.shape and torch.equal(init, task.init_params(3))
    assert torch.equal(init[:8], torch.zeros(8))            # b1
    np.testing.assert_array_equal(task.label_histogram(2), jtask.label_histogram(2))
    assert task.train_cost(2) == jtask.train_cost(2)


@pytest.mark.parametrize("client,seed", [(0, 0), (3, 7), (7, 123456)])
def test_mlp_local_train_matches(tasks, client, seed):
    """One ``local_train`` (4 steps of batch 16) from the same vector with
    the same seed is within 1e-5 of max|p| of the reference's (the same
    numpy batches; the matmuls and the gradient differ in rounding), and
    leaves its input unchanged."""
    task, jtask, flat = tasks
    task4 = MLPTask(task.data, task.partition, hidden=8, local_steps=4, batch=16,
                    device="cpu")
    jtask4 = JMLPTask(jtask.data, jtask.partition, hidden=8, local_steps=4, batch=16)
    jtask4.init_params(0)
    vec = task_params_from_jax(flat)
    got = task4.local_train(vec, client, seed=seed)
    want = jtask4.local_train(flat, client, seed=seed)
    assert torch.equal(vec, task_params_from_jax(flat))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# --------------------------------------------------------------------------
# Engine.run
# --------------------------------------------------------------------------

def _run_both(tasks, method, monkeypatch, **kw):
    """Engine.run on both sides from the reference's initial vector
    (``init_params=`` for the gossip engine; the task's ``init_params``
    replaced for the round engines), counting the port's weighted_mix
    calls."""
    task, jtask, flat = tasks
    vec = task_params_from_jax(flat)
    kw = dict(total_time=6.0, model_bytes=1000, seed=0, **kw)
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
def test_engine_run_matches(tasks, method, monkeypatch):
    """Counters and trace times equal; every trace accuracy within
    2/n_test; final models within ENGINE_TOL of max|p|; one weighted_mix
    call per aggregation, as the engine counts them."""
    task = tasks[0]
    got, want, calls = _run_both(tasks, method, monkeypatch)
    assert isinstance(got, RunResult) and got.method == want.method
    for field in ("comm_bytes_per_client", "messages_per_client", "suppressed_sends",
                  "local_steps_per_client"):
        assert getattr(got, field) == getattr(want, field), field
    assert [r.time for r in got.trace] == [r.time for r in want.trace]
    n_test = len(task.data.y_test)
    for r, s in zip(got.trace, want.trace):
        assert np.abs(r.accs - s.accs).max() <= 2 / n_test
        assert abs(r.mean_acc - s.mean_acc) <= 2 / n_test
    assert len(got.final_params) == len(want.final_params) == task.num_clients
    scale = max(np.abs(np.asarray(p)).max() for p in want.final_params)
    for p, q in zip(got.final_params, want.final_params):
        assert p.dtype == torch.float32
        assert np.abs(p.double().numpy() - np.asarray(q, np.float64)).max() <= ENGINE_TOL * scale
    assert got.aggregations == len(calls) > 0
    rounds = len(got.trace) - 1
    expect = {"fedavg": rounds, "gaia": rounds * 5, "dfl-dds": rounds * task.num_clients}
    if method in expect:
        assert got.aggregations == expect[method]


def test_engine_gossip_aggregation_shapes(tasks, monkeypatch):
    """A gossip wake-up mixes the client's whole (1 + D, N) slot block,
    D the overlay's largest degree; FedAvg mixes the (n, N) local models."""
    task = tasks[0]
    _, _, calls = _run_both(tasks, "fedlay", monkeypatch)
    D = max(baselines.fedlay(task.num_clients, 3).degrees().values())
    assert set(calls) == {(1 + D, task.num_params)}
    _, _, calls = _run_both(tasks, "fedavg", monkeypatch)
    assert set(calls) == {(task.num_clients, task.num_params)}


@pytest.mark.parametrize("method", ["fedlay", "fedavg", "gaia", "dfl-dds"])
def test_engine_hands_host_weights_to_weighted_mix(tasks, method, monkeypatch):
    """Every aggregation hands ``weighted_mix`` its weights, and DFL-DDS
    its mask, as f32 tensors on the host (the kernel carries them in its
    launch), with the models and ``out`` on the task's device."""
    task = tasks[0]
    seen = []

    def recording(models, weights, *, mask=None, out=None):
        seen.append((weights.device.type, weights.dtype,
                     None if mask is None else (mask.device.type, mask.dtype)))
        assert models.device == out.device == task.device
        return weighted_mix(models, weights, mask=mask, out=out)
    monkeypatch.setattr(dfl, "weighted_mix", recording)
    res = Engine().run(task, method, total_time=6.0, model_bytes=1000, seed=0)
    assert len(seen) == res.aggregations > 0
    masked = method == "dfl-dds"
    assert set(seen) == {("cpu", torch.float32,
                          ("cpu", torch.float32) if masked else None)}


def test_engine_obs_plane(tasks):
    """With a bus and a ledger the run records the reference's engine
    counters, one ledger row per snapshot, and the four span histograms."""
    from repro_torch.obs.events import Telemetry
    from repro_torch.obs.rounds import RoundLedger
    task = tasks[0]
    bus, ledger = Telemetry(), RoundLedger()
    res = Engine().run(task, "fedlay", total_time=4.0, model_bytes=100, seed=1,
                       telemetry=bus, ledger=ledger)
    assert len(ledger) == len(res.trace)
    assert bus.counters["engine.evals"] == len(res.trace)
    assert bus.counters["engine.aggregations"] == res.aggregations
    assert bus.counters["engine.msgs_sent"] == res.messages_per_client * task.num_clients
    for name in ("local_train", "fingerprint", "aggregate", "evaluate"):
        assert bus.histograms[f"engine.{name}.ms"].count > 0, name


def test_run_gossip_and_ad_hoc_spec(tasks):
    """``run_gossip`` over an explicit overlay and an ad-hoc spec run as
    the registry's methods do; the round engines refuse a warm start."""
    task = tasks[0]
    topo = baselines.fedlay(task.num_clients, 2)
    a = run_gossip(task, topo, np.ones(task.num_clients), total_time=3.0,
                   model_bytes=10, method_name="x")
    b = Engine().run(task, MethodSpec("x", topology=topo), periods=np.ones(task.num_clients),
                     total_time=3.0, model_bytes=10)
    assert a.method == "x" and [r.mean_acc for r in a.trace] == [r.mean_acc for r in b.trace]
    with pytest.raises(ValueError, match="warm-start"):
        Engine().run(task, "fedavg", total_time=2.0, model_bytes=1,
                     init_params=[task.init_params(0)] * task.num_clients)


def test_resolve_method_matches_reference():
    """The registry's names, the suffixes in either order, and the
    unknown-method error, as the reference's."""
    assert sorted(METHOD_REGISTRY) == sorted(jdfl.METHOD_REGISTRY)
    for name in ("fedlay-noconf-sync", "fedlay-sync-noconf", "fedlay-sync",
                 "fedlay-noconf", "chord-sync", "ring", "fedavg", "gaia-noconf"):
        got, want = resolve_method(name), jdfl.resolve_method(name)
        assert (got.name, got.engine, got.aggregation, got.pacing) == (
            want.name, want.engine, want.aggregation, want.pacing)
    assert resolve_method("fedlay-noconf-sync") == resolve_method("fedlay-sync-noconf")
    with pytest.raises(ValueError, match="fedsky") as exc:
        resolve_method("fedsky-sync")
    assert "fedlay" in str(exc.value) and "fedavg" in str(exc.value)
