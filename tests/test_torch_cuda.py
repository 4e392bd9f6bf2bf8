"""The port on the card: the CUDA ``flash_decode`` kernel against its
plain PyTorch version, and the serving loop on the card against the same
on the CPU.  Every test here needs an NVIDIA GPU and skips without one;
the file imports neither JAX nor the reference package, so it also runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import tiny_lm
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.ref import flash_decode_ref
from repro_torch.models.model import LanguageModel
from repro_torch.runtime.serving import ServeLoop

pytestmark = pytest.mark.cuda

SWEEP = [(1, 4, 1, 64, 256, 255), (2, 8, 2, 64, 700, 450),
         (2, 16, 2, 128, 1024, 100), (1, 8, 8, 64, 512, 511),
         (3, 8, 4, 32, 384, 0),
         # the widest groups the kernel takes at each head_dim
         (2, 32, 2, 64, 300, 200), (1, 16, 1, 128, 500, 499),
         (2, 16, 1, 32, 200, 150), (8, 24, 8, 128, 576, 400),
         # the decode_32k length: 40 spans of 512 rows, small outputs
         (2, 24, 8, 128, 32768, 20000)]


def _tol(ref):
    """By the output's dtype.  f32: 1e-5.  bf16: both sides accumulate in
    f32 and round once to bf16 (at most one bf16 step, 2^-7 of a value),
    so rtol 1e-2 and an atol of 1e-2 x max |ref|, scaled because the
    output over a long cache is small and a fixed atol would pass a lost
    span of it."""
    if ref.dtype == torch.float32:
        return dict(rtol=0.0, atol=1e-5)
    return dict(rtol=1e-2, atol=1e-2 * ref.float().abs().max().item())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rand(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,hd,L,pos", SWEEP)
def test_kernel_matches_plain(cuda, B, Hq, Hkv, hd, L, pos, dtype):
    gen = torch.Generator(device=cuda).manual_seed(L)
    q = _rand(gen, B, Hq, hd, dtype=dtype)
    k, v = _rand(gen, B, L, Hkv, hd, dtype=dtype), _rand(gen, B, L, Hkv, hd, dtype=dtype)
    before = flash_decode.launches
    out = flash_decode(q, k, v, pos)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    ref = flash_decode_ref(q, k, v, pos)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(ref))


@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.bfloat16, torch.float32),
                                              (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("L", [64, 130, 160, 512, 700, 4096])
def test_kernel_pos_vector_empty_rows(cuda, L, q_dtype, kv_dtype):
    gen = torch.Generator(device=cuda).manual_seed(L)
    q = _rand(gen, 5, 8, 32, dtype=q_dtype)
    k, v = _rand(gen, 5, L, 2, 32, dtype=kv_dtype), _rand(gen, 5, L, 2, 32, dtype=kv_dtype)
    pos = torch.tensor([0, L // 2, L - 1, -1, L + 3], dtype=torch.int32,
                       device=cuda)
    out = flash_decode(q, k, v, pos)
    assert out.dtype == q_dtype
    ref = flash_decode_ref(q, k, v, pos)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(ref))
    assert torch.all(out[3] == 0)


def test_kernel_reads_strided_cache(cuda):
    """A cache that is a view of a larger tensor is read in place."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    k = _rand(gen, 4, 300, 2, 64)[::2]              # strided batch axis
    v = _rand(gen, 2, 300, 4, 64)[:, :, 1:3]        # strided head axis
    assert not k.is_contiguous() and not v.is_contiguous()
    q = _rand(gen, 2, 8, 64)
    pos = torch.tensor([299, 17], dtype=torch.int32, device=cuda)
    ref = flash_decode_ref(q, k, v, pos)
    torch.testing.assert_close(flash_decode(q, k, v, pos), ref, **_tol(ref))


def test_kernel_rejects_bad_layouts(cuda):
    q = torch.zeros((2, 8, 64), device=cuda)
    k = torch.zeros((2, 64, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_decode(q.half(), k, k, 3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode(torch.zeros((8, 2, 64), device=cuda).transpose(0, 1), k, k, 3)
    strided = torch.zeros((2, 64, 2, 128), device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        flash_decode(q, strided, k, 3)
    with pytest.raises(ValueError, match="devices"):
        flash_decode(q, k.cpu(), k.cpu(), 3)
    unaligned = torch.zeros((2, 64, 2, 65), device=cuda)[..., 1:]
    with pytest.raises(ValueError, match="boundaries"):
        flash_decode(q, unaligned, unaligned, 3)
    for hd in (48, 256):
        kh = torch.zeros((2, 64, 2, hd), device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            flash_decode(torch.zeros((2, 8, hd), device=cuda), kh, kh, 3)
    with pytest.raises(ValueError, match="query heads per KV head"):
        flash_decode(torch.zeros((2, 64, 64), device=cuda), k, k, 3)


def test_serve_loop_card_matches_cpu(cuda):
    cfg = tiny_lm(layers=2)
    cpu = LanguageModel(cfg, torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(1, 9))),
             int(rng.integers(2, 9))) for _ in range(6)]
    done = []
    for model in (cpu, gpu):
        loop = ServeLoop(model, capacity=3, cache_len=24, prompt_len=8)
        for prompt, max_new in reqs:
            loop.submit(prompt, max_new=max_new)
        done.append({r.rid: r.tokens for r in loop.run()})
    assert done[0] == done[1]
