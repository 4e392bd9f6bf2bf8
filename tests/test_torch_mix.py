"""The port's mixing round against the JAX reference on the CPU:
``round_matrix`` and ``gather_mix`` (the plain path) against JAX
``gather_mix`` in interpret mode and ``gather_mix_ref``, and
``global_mixer`` for every strategy, masked, with and without
``edge_mask`` and ``flat_io``, against JAX ``global_mixer`` and the dense
oracle ``masked_mixing_matrix``, all on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mixing import build_permute_schedule as j_build
from repro.core.mixing import masked_mixing_matrix as j_masked_matrix
from repro.dist.sync import global_mixer as j_global_mixer
from repro.dist.sync import ring_schedule as j_ring_schedule
from repro.dist.sync import sync_bytes_per_client as j_sync_bytes
from repro.kernels.ref import gather_mix_ref as j_gather_mix_ref
from repro.kernels.weighted_mix import gather_mix as j_gather_mix
from repro.kernels.weighted_mix import round_matrix as j_round_matrix
from repro_torch.core.mixing import (build_permute_schedule, masked_mixing_matrix,
                                     pad_schedule, schedule_mixing_matrix)
from repro_torch.dist.flat import FlatSpec
from repro_torch.dist.sync import (check_fuse, global_mixer, resolve_wire,
                                   ring_schedule, sync_bytes_per_client)
from repro_torch.kernels.gather_mix import gather_mix
from repro_torch.kernels.ref import gather_mix_ref, round_matrix

F32_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep each xdist worker's intra-op pool small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _table(C, K1, seed):
    """A (C, K1) source table with duplicates (column 1 repeats column 0
    in every other row) and weights in [0, 1)."""
    rng = np.random.default_rng(seed)
    srcs = rng.integers(0, C, (C, K1))
    srcs[::2, 1] = srcs[::2, 0]
    return srcs, rng.random((C, K1)).astype(np.float32)


# --------------------------------------------------------------------------
# round_matrix and gather_mix
# --------------------------------------------------------------------------

@pytest.mark.parametrize("C", [1, 3, 8, 33])
def test_round_matrix_matches_jax(C):
    srcs, w = _table(C, 5, C)
    want = np.asarray(j_round_matrix(C, srcs, jnp.asarray(w)))
    got = round_matrix(C, srcs, torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (C, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)
    # a tensor table gives the same matrix
    got_t = round_matrix(C, torch.from_numpy(srcs), torch.from_numpy(w))
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())


def test_round_matrix_rejects_bad_tables_with_the_reference_messages():
    w = torch.ones((3, 2))
    with pytest.raises(ValueError, match="out of range for 3 clients"):
        round_matrix(3, np.array([[0, 3], [1, 1], [2, 2]]), w)
    with pytest.raises(ValueError, match="do not match"):
        round_matrix(3, np.zeros((2, 2), np.int64), torch.ones((2, 2)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,N", [(1, 5), (3, 130), (8, 1000), (33, 257)])
def test_gather_mix_matches_jax(C, N, dtype):
    """Against JAX gather_mix (interpret mode) and gather_mix_ref: f32
    within 1e-6 (max |buf| is about 4, and the sums are short); bf16
    within one bf16 step of the f32 result (2^-7 relative), since both
    round the same f32 sum once."""
    srcs, w = _table(C, 5, N)
    rng = np.random.default_rng(C)
    x = rng.normal(size=(C, N)).astype(np.float32)
    jbuf = jnp.asarray(x).astype(getattr(jnp, dtype))
    buf = torch.from_numpy(x).to(getattr(torch, dtype))
    want_kernel = np.asarray(j_gather_mix(jbuf, srcs, jnp.asarray(w),
                                          interpret=True).astype(jnp.float32))
    want_ref = np.asarray(j_gather_mix_ref(jbuf, srcs, jnp.asarray(w)
                                           ).astype(jnp.float32))
    got = gather_mix(buf, srcs, torch.from_numpy(w))
    assert got.dtype == buf.dtype and got.shape == (C, N)
    plain = gather_mix_ref(buf, srcs, torch.from_numpy(w))
    assert torch.equal(got, plain)
    tol = (dict(rtol=0, atol=F32_TOL) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=2 ** -7 * np.abs(want_ref).max()))
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_gather_mix_writes_a_given_or_aliased_output():
    srcs, w = _table(4, 3, 0)
    x = torch.randn((4, 64), generator=torch.Generator().manual_seed(0))
    want = gather_mix_ref(x, srcs, torch.from_numpy(w))
    out = torch.empty_like(x)
    assert gather_mix(x, srcs, torch.from_numpy(w), out=out) is out
    assert torch.equal(out, want)
    inplace = x.clone()
    assert gather_mix(inplace, srcs, torch.from_numpy(w), out=inplace) is inplace
    assert torch.equal(inplace, want)
    with pytest.raises(ValueError, match="out must be"):
        gather_mix(x, srcs, torch.from_numpy(w), out=torch.empty((4, 63)))
    with pytest.raises(ValueError, match=r"\(C, N\) buffer"):
        gather_mix(x[0], srcs, torch.from_numpy(w))


# --------------------------------------------------------------------------
# global_mixer
# --------------------------------------------------------------------------

def _schedule(C=8, live=(0, 1, 2, 4, 5, 6), L=2):
    """A fedlay schedule over ``live`` padded to C slots."""
    return pad_schedule(build_permute_schedule(len(live), L), list(live), C)


def _j_schedule(C=8, live=(0, 1, 2, 4, 5, 6), L=2):
    from repro.core.mixing import pad_schedule as j_pad
    return j_pad(j_build(len(live), L), list(live), C)


def _inputs(C=8, seed=0):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(C, 3, 50)).astype(np.float32),
            "b": rng.normal(size=(C, 7)).astype(np.float32)}
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 0], np.float32)[:C]
    edge = np.ones((C, 4), np.float32)
    edge[0, 1] = edge[5, 0] = edge[2, :] = 0.0
    return tree, mask, edge


@pytest.mark.parametrize("strategy", ["fedlay", "ring", "allreduce", "none"])
@pytest.mark.parametrize("use_edge", [False, True])
@pytest.mark.parametrize("fuse", ["flat", None])
def test_masked_global_mixer_matches_jax(strategy, use_edge, fuse):
    """On trees: the port and JAX mixers within 1e-6 (f32 sums of five
    terms); for fedlay / ring also the dense oracle."""
    tree, mask, edge = _inputs()
    if strategy == "ring":
        sched, jsched = ring_schedule(8), j_ring_schedule(8)
        edge = edge[:, :2]
    else:
        sched, jsched = _schedule(), _j_schedule()
    kw = {"edge_mask": edge} if use_edge else {}
    jmix = j_global_mixer(strategy, jsched, masked=True, fuse=fuse)
    tmix = global_mixer(strategy, sched, masked=True, fuse=fuse)
    want = jmix({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(mask),
                **({k: jnp.asarray(v) for k, v in kw.items()}))
    got = tmix({k: torch.from_numpy(v) for k, v in tree.items()}, mask, **kw)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=F32_TOL)
    if strategy in ("fedlay", "ring"):
        W = masked_mixing_matrix(sched, mask, edge if use_edge else None)
        np.testing.assert_allclose(
            W, j_masked_matrix(jsched, mask, edge if use_edge else None), atol=0)
        for k, v in tree.items():
            dense = (W @ v.reshape(8, -1)).reshape(v.shape)
            np.testing.assert_allclose(got[k].numpy(), dense, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("strategy", ["fedlay", "ring"])
@pytest.mark.parametrize("use_edge", [False, True])
def test_flat_io_mixer_matches_jax_and_writes_out(strategy, use_edge):
    """flat_io: the (C, N) buffer in and out, within 1e-6 of the JAX
    flat_io mixer; ``out`` is written (and may be the input)."""
    tree, mask, edge = _inputs(seed=1)
    if strategy == "ring":
        sched, jsched, edge = ring_schedule(8), j_ring_schedule(8), edge[:, :2]
    else:
        sched, jsched = _schedule(), _j_schedule()
    kw = {"edge_mask": edge} if use_edge else {}
    spec = FlatSpec.for_tree({k: torch.from_numpy(v) for k, v in tree.items()})
    buf = spec.ravel({k: torch.from_numpy(v) for k, v in tree.items()})
    jmix = j_global_mixer(strategy, jsched, masked=True, fuse="flat", flat_io=True)
    want = np.asarray(jmix(jnp.asarray(buf.numpy()), jnp.asarray(mask),
                           **({k: jnp.asarray(v) for k, v in kw.items()})))
    tmix = global_mixer(strategy, sched, masked=True, fuse="flat", flat_io=True)
    out = torch.empty_like(buf)
    assert tmix(buf, mask, out=out, **kw) is out
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=F32_TOL)
    # dead rows are the input rows, exactly
    dead = np.flatnonzero(mask == 0)
    assert torch.equal(out[dead], buf[dead])
    inplace = buf.clone()
    tmix(inplace, mask, out=inplace, **kw)
    assert torch.equal(inplace, out)


def test_unmasked_mixers_match_jax_and_the_schedule_matrix():
    tree, _, _ = _inputs(seed=2)
    sched = build_permute_schedule(8, 3)
    W = schedule_mixing_matrix(sched)
    for strategy, fuse in [("fedlay", "flat"), ("fedlay", None), ("allreduce", None)]:
        got = global_mixer(strategy, sched, fuse=fuse)(
            {k: torch.from_numpy(v) for k, v in tree.items()})
        want = j_global_mixer(strategy, j_build(8, 3), fuse=fuse)(
            {k: jnp.asarray(v) for k, v in tree.items()})
        for k, v in tree.items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=F32_TOL)
            if strategy == "fedlay":
                np.testing.assert_allclose(
                    got[k].numpy(), (W @ v.reshape(8, -1)).reshape(v.shape),
                    rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("strategy", ["allreduce", "none"])
def test_flat_io_needs_fedlay_or_ring_and_codecs_wait(strategy):
    with pytest.raises(ValueError, match="flat_io"):
        global_mixer(strategy, None, masked=True, fuse="flat", flat_io=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        global_mixer(strategy, None, codec="int8-block")
    with pytest.raises(ValueError, match="fuse"):
        check_fuse("fused")
    assert resolve_wire(None, "tree") == (None, None)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_ring_schedule_matches_jax(n):
    a, b = ring_schedule(n), j_ring_schedule(n)
    assert a.perms == b.perms
    np.testing.assert_array_equal(a.weights, b.weights)
    np.testing.assert_array_equal(a.self_weight, b.self_weight)


@pytest.mark.parametrize("strategy", ["fedlay", "ring", "complete", "allreduce", "none"])
def test_sync_bytes_per_client_matches_jax(strategy):
    for n, G, K in [(8, 1, None), (8, 2, 5), (16, 4, 16), (6, 3, 1)]:
        kw = dict(num_spaces=2, clients_per_device=G, active_clients=K)
        assert sync_bytes_per_client(strategy, 4096, n, **kw) == \
            j_sync_bytes(strategy, 4096, n, **kw)
