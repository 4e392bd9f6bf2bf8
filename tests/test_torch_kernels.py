"""The port's ``flash_decode`` against the JAX reference.

On the CPU the wrapper runs its plain version; it is held to the JAX
Pallas kernel (``interpret=True``, as the JAX tests run it) and to
``flash_decode_ref`` on the same numpy inputs.  The CUDA kernel is held
to the plain version on the card in ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("B,Hkv,L", [(16, 8, 32768), (8, 8, 576), (1, 1, 256),
                                     (5, 2, 700), (1, 8, 40), (64, 8, 100)])
def test_flash_decode_splits_cover_the_cache(B, Hkv, L):
    """The CUDA launch's L spans: every cache row in exactly one span,
    at most MAX_CHUNK rows, and no more spans than MIN_CHUNK-row pieces
    of L."""
    n_split, chunk = fd_module._splits(B, Hkv, L, sms=132)
    assert (n_split - 1) * chunk < L <= n_split * chunk
    assert chunk <= fd_module.MAX_CHUNK
    assert n_split <= -(-L // fd_module.MIN_CHUNK)


def test_ref_empty_row_exact_zero():
    rng = np.random.default_rng(1)
    q, k, v = _torch(_inputs(rng, 3, 4, 2, 16, 160), torch.float32)
    out = flash_decode_ref(q, k, v, torch.tensor([-1, 5, -1]))
    assert torch.all(out[0] == 0) and torch.all(out[2] == 0)
    assert out[1].abs().max() > 0
