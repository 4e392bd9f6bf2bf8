"""Why the CUDA ``ssd_scan`` multiplies in split TF32.

The kernel (``src/repro_torch/kernels/csrc/ssd_scan.cu``) runs every
product of the SSD dual form on the tensor cores in TF32, whose operands
keep 10 of f32's 23 mantissa bits.  It splits each f32 operand
a = a_hi + a_lo, both parts rounded to TF32 as ``cvt.rna.tf32.f32`` does,
and sums a_lo·b_hi + a_hi·b_lo + a_hi·b_hi in f32.  This file models that
arithmetic in plain torch on the CPU: the kernel's three passes (the
chunks' own states, the state passing, the chunks' outputs, with C·Bᵀ
formed once for all heads), each product through the model.  At
Mamba2-370m's ranges (H 32, A = −1 … −32, Q 256, P 64, N 128) the split
meets the card's f32 limit for the kernel against ``ssd_chunked_ref``,
(1e-5 + 8·2^-24·cs_h)·max|ref_h| per head (``tests/test_torch_cuda.py``,
``chip_smoke.py``), and plain TF32 does not.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import chunk_len, ssd_chunked_ref

#: the card's per-head limit: (BASE + CS_FACTOR·2^-24·cs_h)·max|ref_h|
BASE, CS_FACTOR = 1e-5, 8


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest on the
    low 13 mantissa bits, ties away from zero (a carry into the exponent
    is the next power of two)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's tensor-core products compute it: the two
    cross terms, then the product of the high parts, f32 sums."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def plain_tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def kernel_model(x, dt, A, Bm, Cm, chunk, mm):
    """The kernel's three passes with every product through ``mm``:
    1. per chunk, cs = the cumsum of dt·A and the chunk's own state
       (x·dt·exp(cs_end − cs))ᵀ·B;
    2. the states passed from chunk to chunk, state·exp(cs_end) + S_c,
       each chunk keeping the state that enters it;
    3. per chunk, G = C·Bᵀ once for every head, then
       y = (G ∘ L_h)·(dt·x) + exp(cs)·C·(entering state)ᵀ."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk_len(S, chunk)
    nc = S // Q
    cs = (dt * A[None, None, :]).reshape(Bsz, nc, Q, H).cumsum(2).permute(0, 1, 3, 2)
    xdt = (x * dt[..., None]).reshape(Bsz, nc, Q, H, P).permute(0, 1, 3, 2, 4)
    Bc = Bm.reshape(Bsz, nc, 1, Q, N)
    Cc = Cm.reshape(Bsz, nc, 1, Q, N)
    own = mm((xdt * torch.exp(cs[..., -1:] - cs)[..., None]).transpose(-1, -2), Bc)
    state = torch.zeros((Bsz, H, P, N))
    entering = torch.empty_like(own)
    for c in range(nc):
        entering[:, c] = state
        state = state * torch.exp(cs[:, c, :, -1])[..., None, None] + own[:, c]
    L = cs[..., :, None] - cs[..., None, :]
    L.masked_fill_(~torch.ones((Q, Q), dtype=torch.bool).tril(), float("-inf")).exp_()
    y = mm(L * mm(Cc, Bc.transpose(-1, -2)), xdt)
    y += torch.exp(cs)[..., None] * mm(Cc, entering.transpose(-1, -2))
    return y.permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P), state


def head_errors(got, ref, dt, A, Q, head_dim):
    """Per head: max |got − ref| and the card's limit for it."""
    B, S, H = dt.shape
    cs = (dt * A).reshape(B, S // Q, Q, H).sum(2).abs().amax(dim=(0, 1))
    g, r = got.movedim(head_dim, 0), ref.movedim(head_dim, 0)
    limit = (BASE + CS_FACTOR * 2.0 ** -24 * cs) * r.abs().reshape(H, -1).amax(dim=1)
    return (g - r).abs().reshape(H, -1).amax(dim=1), limit


@pytest.fixture(scope="module")
def mamba2_ranges():
    """Mamba2-370m's head layout and ranges (the mixer's init: dt a
    softplus of N(0, 1), A = −(1..32)) over four chunks of 256, the
    plain version's y and final state, and both models'."""
    rng = np.random.default_rng(0)
    B, S, H, P, N, chunk = 1, 1024, 32, 64, 128, 256
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, H), dtype=np.float32)))
    A = -torch.arange(1, H + 1, dtype=torch.float32)
    x, Bm, Cm = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                 for shape in ((B, S, H, P), (B, S, N), (B, S, N)))
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ref = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
        runs = {name: kernel_model(x, dt, A, Bm, Cm, chunk, mm)
                for name, mm in (("split", split_mm), ("plain", plain_tf32_mm))}
    finally:
        torch.set_num_threads(before)
    return dt, A, chunk_len(S, chunk), ref, runs


def test_tf32_rounding():
    """Round to nearest on the low 13 bits, ties away from zero; within
    2^-11 relative; a carry runs into the exponent."""
    one = 1.0 + 2.0 ** -11                       # halfway between two TF32 numbers
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 1.0 - 2.0 ** -13, 0.0], dtype=torch.float32)
    assert tf32(x).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 1.0, 0.0]
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(4096, dtype=np.float32))
    t = tf32(r)
    assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((t - r).abs() <= 2.0 ** -11 * r.abs()).all())
    # the split keeps f32's accuracy: a_hi + a_lo within 2^-22 of a
    lo = tf32(r - t)
    assert bool(((t.double() + lo.double() - r.double()).abs() <= 2.0 ** -22 * r.abs()).all())


def test_bf16_is_exact_in_tf32():
    """bf16 data (8 significant bits) is a TF32 number: the kernel's bf16
    C·Bᵀ takes one product and no low part."""
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(4096, dtype=np.float32))
    b = r.bfloat16().float()
    assert torch.equal(tf32(b), b)


@pytest.mark.parametrize("what", ["y", "state"])
def test_split_tf32_meets_the_card_limit(mamba2_ranges, what):
    dt, A, Q, (ref_y, ref_state), runs = mamba2_ranges
    y, state = runs["split"]
    got, ref, head_dim = (y, ref_y, 2) if what == "y" else (state, ref_state, 1)
    err, limit = head_errors(got, ref, dt, A, Q, head_dim)
    # with room: the split's error read about 0.3 % of the limit
    assert bool((err <= 0.1 * limit).all()), (err / limit).max()


@pytest.mark.parametrize("what", ["y", "state"])
def test_plain_tf32_fails_the_card_limit(mamba2_ranges, what):
    dt, A, Q, (ref_y, ref_state), runs = mamba2_ranges
    y, state = runs["plain"]
    got, ref, head_dim = (y, ref_y, 2) if what == "y" else (state, ref_state, 1)
    err, limit = head_errors(got, ref, dt, A, Q, head_dim)
    # about 5e-4 of max|ref_h| in the heads of small |A|, against about 1e-4
    assert bool((err > limit).any()), (err / limit).max()
