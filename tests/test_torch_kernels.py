"""The port's ``flash_decode`` against the JAX reference.

On the CPU the wrapper runs its plain version; it is held to the JAX
Pallas kernel (``interpret=True``, as the JAX tests run it) and to
``flash_decode_ref`` on the same numpy inputs.  The CUDA kernel is held
to the plain version on the card in ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.ref import flash_decode_ref as jax_flash_decode_ref
from repro_torch.kernels import flash_decode as fd_module
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.ref import flash_decode_ref

# the reference sweep's own tolerances (tests/test_kernels.py)
TOLS = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SWEEP = [
    (1, 4, 1, 64, 256, 128, 255),
    (2, 8, 2, 64, 700, 128, 450),
    (2, 16, 2, 128, 1024, 512, 100),
    (1, 8, 8, 64, 512, 256, 511),
    (3, 8, 4, 32, 384, 128, 0),
]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep each xdist worker's intra-op pool small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(rng, B, Hq, Hkv, hd, L):
    return (rng.standard_normal((B, Hq, hd)).astype(np.float32),
            rng.standard_normal((B, L, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, L, Hkv, hd)).astype(np.float32))


def _torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays]


def _np(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,hd,L,bl,pos", SWEEP)
def test_flash_decode_sweep_matches_jax(B, Hq, Hkv, hd, L, bl, pos, dtype):
    arrays = _inputs(np.random.default_rng(L + hd), B, Hq, Hkv, hd, L)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    kernel = np.asarray(jax_flash_decode(jq, jk, jv, pos, block_l=bl,
                                         interpret=True), np.float32)
    ref = np.asarray(jax_flash_decode_ref(jq, jk, jv, pos), np.float32)
    out = _np(flash_decode(*_torch(arrays, getattr(torch, dtype)), pos))
    tol = dict(rtol=0, atol=1e-5) if dtype == "float32" else TOLS[dtype]
    np.testing.assert_allclose(out, ref, **tol)
    np.testing.assert_allclose(out, kernel, **tol)


@pytest.mark.parametrize("L", [64, 130, 160, 512, 700])
def test_flash_decode_pos_vector_empty_rows(L):
    """Per-slot pos with live, boundary and empty rows: within 1e-5 of
    both JAX functions, and the empty row exactly 0."""
    rng = np.random.default_rng(L)
    arrays = _inputs(rng, 5, 8, 2, 32, L)
    pos = np.asarray([0, L // 2, L - 1, -1, 3], np.int32)
    jargs = [jnp.asarray(a) for a in arrays]
    kernel = np.asarray(jax_flash_decode(*jargs, jnp.asarray(pos),
                                         interpret=True))
    ref = np.asarray(jax_flash_decode_ref(*jargs, jnp.asarray(pos)))
    out = _np(flash_decode(*_torch(arrays, torch.float32),
                           torch.from_numpy(pos)))
    assert np.abs(out - ref).max() <= 1e-5
    assert np.abs(out - kernel).max() <= 1e-5
    assert np.all(out[3] == 0.0)


def test_flash_decode_pos_past_cache_follows_ref():
    """pos = L + 3 with L = 700 (not a block multiple): the port counts
    only idx < L, as flash_decode_ref does.  The JAX Pallas kernel lets
    its zero padding into the softmax here, so it is not compared."""
    rng = np.random.default_rng(3)
    L = 700
    arrays = _inputs(rng, 2, 8, 2, 32, L)
    ref = np.asarray(jax_flash_decode_ref(*[jnp.asarray(a) for a in arrays],
                                          L + 3))
    out = _np(flash_decode(*_torch(arrays, torch.float32), L + 3))
    assert np.abs(out - ref).max() <= 1e-5
    full = _np(flash_decode(*_torch(arrays, torch.float32), L - 1))
    assert np.abs(out - full).max() == 0.0


def test_flash_decode_scalar_tensor_pos_and_mixed_dtypes():
    """A 0-d pos tensor equals the int; bf16 q over an f32 cache (the
    serving layout with bf16 weights) returns bf16."""
    rng = np.random.default_rng(4)
    q, k, v = _torch(_inputs(rng, 2, 4, 2, 16, 96), torch.float32)
    a = flash_decode(q, k, v, 7)
    b = flash_decode(q, k, v, torch.tensor(7))
    assert torch.equal(a, b)
    out = flash_decode(q.bfloat16(), k, v, 7)
    assert out.dtype == torch.bfloat16
    assert (out.float() - a).abs().max() <= 2e-2


def test_flash_decode_rejects_bad_inputs():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 7, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 64, 2, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="integer multiple"):
        flash_decode(q, k, k, 3)
    q8 = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="per-slot vector"):
        flash_decode(q8, k, k, torch.zeros((3,), dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        flash_decode(q8, k, k[:, :, :, :8], 3)


@st.composite
def _layouts(draw, kind):
    """(B, Hkv, L, sms, pos) with ``pos`` of one kind: live rows, empty
    slots and pos >= L mixed; every slot empty; one live slot among many
    empty ones; every pos at or past L; rows of 0 or 1 entries; every row
    live and inside the cache."""
    B = draw(st.integers(1, 48))
    Hkv = draw(st.integers(1, 16))
    L = draw(st.integers(1, 3000))
    sms = draw(st.integers(1, 264))
    if kind == "mixed":
        pos = draw(st.lists(st.integers(-5, L + 40), min_size=B, max_size=B))
    elif kind == "all_empty":
        pos = draw(st.lists(st.integers(-9, -1), min_size=B, max_size=B))
    elif kind == "one_live":
        pos = [-1] * B
        pos[draw(st.integers(0, B - 1))] = draw(st.integers(0, 2 * L))
    elif kind == "past_cache":
        pos = draw(st.lists(st.integers(L - 1, L + 100), min_size=B, max_size=B))
    elif kind == "tiny_rows":
        pos = draw(st.lists(st.integers(-1, 0), min_size=B, max_size=B))
    else:
        pos = draw(st.lists(st.integers(0, L - 1), min_size=B, max_size=B))
    return B, Hkv, L, sms, pos


@pytest.mark.parametrize("kind", ["mixed", "all_empty", "one_live",
                                  "past_cache", "tiny_rows", "full"])
@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(data=st.data())
def test_flash_decode_partition_covers_the_valid_rows(kind, data):
    """The mirror of the kernel's work partition: every valid row of every
    (b, KV head) lies in exactly one span; no span is empty, and every
    block has one when there are at least as many valid rows as blocks;
    the spans of a (b, KV head) sit Hkv blocks apart in row order (the
    merge's order); the grid depends on the shapes alone and holds a
    block for each slot's zeros; the partials and tickets fit the
    wrapper's scratch."""
    B, Hkv, L, sms, pos = data.draw(_layouts(kind))
    G = data.draw(st.integers(1, fd_module.MAX_GROUP))
    hd = data.draw(st.sampled_from(fd_module.HEAD_DIMS))
    per_sm = fd_module.blocks_per_sm(data.draw(st.sampled_from([2, 4])), G)
    n_blocks = fd_module.grid_blocks(B, Hkv, L, sms, per_sm)
    assert n_blocks % Hkv == 0 and B * Hkv <= n_blocks <= B * Hkv * L
    assert n_blocks <= max(B * Hkv, per_sm * sms + Hkv - 1)
    spans = fd_module.partition(pos, Hkv, L, n_blocks)
    assert len(spans) == n_blocks
    valid = [0 if p < 0 else min(p + 1, L) for p in pos]
    total = Hkv * sum(valid)
    busy = [i for i, sp in enumerate(spans) if sp is not None]
    assert len(busy) == min(n_blocks, total)
    assert busy == list(range(len(busy)))
    floats, ints = fd_module.scratch_sizes(B, G * Hkv, Hkv, hd, n_blocks)
    by_unit = {}
    for i in busy:
        b, h, r0, r1, first, count = spans[i]
        assert 0 <= r0 < r1 <= valid[b] and i % Hkv == h
        assert i in range(first, first + count * Hkv, Hkv)
        stride = -(-G * (hd + 2) // 4) * 4    # a partial, padded to 16 bytes
        assert (i + 1) * stride <= floats and b * Hkv + h < ints
        by_unit.setdefault((b, h), []).append((i, r0, r1, first, count))
    for b in range(B):
        for h in range(Hkv):
            got = by_unit.get((b, h), [])
            if not valid[b]:
                assert got == []
                continue
            _, _, _, first, count = got[0]
            assert [g[0] for g in got] == list(range(first, first + count * Hkv, Hkv))
            assert 1 <= count <= valid[b]
            rows = [r for _, r0, r1, _, _ in got for r in range(r0, r1)]
            assert rows == list(range(valid[b]))


@pytest.mark.parametrize("B,Hkv,L", [(16, 8, 32768), (8, 8, 576), (1, 1, 256),
                                     (5, 2, 700), (1, 8, 40), (64, 8, 100)])
def test_flash_decode_splits_cover_the_cache(B, Hkv, L):
    """Full caches on an H100's 132 SMs: every cache row of every (b, KV
    head) in exactly one span, the rows shared out evenly (a row's span
    count within one of every other row's, its span lengths within one
    of each other), and every block busy when the cache has the rows."""
    for per_sm in (2, 4):
        n_blocks = fd_module.grid_blocks(B, Hkv, L, 132, per_sm)
        spans = fd_module.partition([L - 1] * B, Hkv, L, n_blocks)
        assert all(sp is not None for sp in spans[:min(n_blocks, B * Hkv * L)])
        by_unit = {}
        for sp in spans:
            if sp is not None:
                b, h, r0, r1, _, _ = sp
                by_unit.setdefault((b, h), []).append((r0, r1))
        assert sorted(by_unit) == [(b, h) for b in range(B) for h in range(Hkv)]
        counts = [len(got) for got in by_unit.values()]
        assert max(counts) - min(counts) <= 1
        for got in by_unit.values():
            assert [r for r0, r1 in got for r in range(r0, r1)] == list(range(L))
            lengths = [r1 - r0 for r0, r1 in got]
            assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1


def _kernel_model(q, k, v, pos, n_blocks):
    """The kernel's arithmetic in float64 torch: each span of
    :func:`partition` scored tile by tile (TILE_ROWS rows) with a running
    max rescaled once a tile, then a unit's partials merged in span
    order."""
    B, Hq, hd = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    out = torch.zeros(B, Hq, hd, dtype=torch.float64)
    parts = {}
    for span in fd_module.partition(pos, Hkv, L, n_blocks):
        if span is None:
            continue
        b, h, r0, r1, first, count = span
        qg = q[b, h * G:(h + 1) * G].double()
        m = torch.full((G,), -1e30, dtype=torch.float64)
        l = torch.zeros(G, dtype=torch.float64)
        acc = torch.zeros(G, hd, dtype=torch.float64)
        for t in range(r0, r1, fd_module.TILE_ROWS):
            kt = k[b, t:min(t + fd_module.TILE_ROWS, r1), h].double()
            vt = v[b, t:min(t + fd_module.TILE_ROWS, r1), h].double()
            s = qg @ kt.T * hd ** -0.5
            m_new = torch.maximum(m, s.max(dim=1).values)
            p = torch.exp(s - m_new[:, None])
            alpha = torch.exp(m - m_new)
            l, m = l * alpha + p.sum(dim=1), m_new
            acc = acc * alpha[:, None] + p @ vt
        parts.setdefault((b, h), []).append((first, m, l, acc))
    for (b, h), ps in parts.items():
        mx = torch.stack([m for _, m, _, _ in ps]).max(dim=0).values
        lsum = sum(l * torch.exp(m - mx) for _, m, l, _ in ps)
        acc = sum(a * torch.exp(m - mx)[:, None] for _, m, _, a in ps)
        out[b, h * G:(h + 1) * G] = acc / lsum[:, None]
    return out


@pytest.mark.parametrize("B,Hq,Hkv,hd,L,pos,sms", [
    (8, 24, 8, 32, 576, [-1, 100, 575, -1, 63, 64, 511, 300], 4),
    (1, 4, 1, 64, 1, [0], 1),
    (3, 8, 2, 32, 95, [94, 200, -1], 2),
    (4, 16, 1, 32, 700, [699, 1, 0, 33], 3),
    (16, 8, 2, 16, 40, [-1] * 15 + [39], 5),
    (2, 6, 2, 16, 257, [256, 128], 132)])
def test_flash_decode_partition_model_matches_ref(B, Hq, Hkv, hd, L, pos, sms):
    """Spans, tiles and the in-order merge of the kernel's design give
    ``flash_decode_ref``'s result (float64 model against the f32 plain
    version, 1e-5), with empty rows exactly 0."""
    arrays = _inputs(np.random.default_rng(L + B), B, Hq, Hkv, hd, L)
    q, k, v = _torch(arrays, torch.float32)
    n_blocks = fd_module.grid_blocks(B, Hkv, L, sms, 2)
    got = _kernel_model(q, k, v, pos, n_blocks)
    ref = flash_decode_ref(q, k, v, torch.tensor(pos)).double()
    assert (got - ref).abs().max() <= 1e-5
    for b, p in enumerate(pos):
        if p < 0:
            assert torch.all(got[b] == 0)


def test_ref_empty_row_exact_zero():
    rng = np.random.default_rng(1)
    q, k, v = _torch(_inputs(rng, 3, 4, 2, 16, 160), torch.float32)
    out = flash_decode_ref(q, k, v, torch.tensor([-1, 5, -1]))
    assert torch.all(out[0] == 0) and torch.all(out[2] == 0)
    assert out[1].abs().max() > 0
