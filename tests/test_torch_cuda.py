"""The port on the card: the CUDA ``flash_decode`` and ``gather_mix``
kernels against their plain PyTorch versions, and the serving and slot
training loops on the card against the same on the CPU.  Every test here needs an NVIDIA GPU and skips without one;
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
from repro_torch.kernels.gather_mix import gather_mix
from repro_torch.kernels.ref import flash_decode_ref, gather_mix_ref
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


# --------------------------------------------------------------------------
# gather_mix
# --------------------------------------------------------------------------

def _mix_tol(buf):
    """f32: 1e-6 x max|buf| (rows of weights summing to 1, a few f32
    roundings).  bf16: both sides round the same f32 sum once, one bf16
    step (2^-7 of a value) apart at most, plus the f32 part near 0."""
    scale = buf.float().abs().max().item()
    if buf.dtype == torch.float32:
        return dict(rtol=0.0, atol=1e-6 * scale)
    return dict(rtol=2 ** -7, atol=1e-6 * scale)


def _mix_table(gen, C, K1=5):
    """Column 0 self, random sources with a duplicate in every other
    row, weights summing to 1 per row."""
    srcs = torch.randint(0, C, (C, K1), generator=gen, device=gen.device)
    srcs[:, 0] = torch.arange(C, device=gen.device)
    srcs[::2, 2] = srcs[::2, 1]
    w = torch.rand((C, K1), generator=gen, device=gen.device)
    return srcs, w / w.sum(dim=1, keepdim=True)


MIX_SHAPES = [(2, 1), (3, 130), (8, 4096), (8, 1001), (9, 4100), (16, 2050),
              (32, 777), (33, 4096), (64, 3001), (200, 1000), (224, 257)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,N", MIX_SHAPES)
def test_gather_mix_matches_plain(cuda, C, N, dtype):
    gen = torch.Generator(device=cuda).manual_seed(C * 7919 + N)
    buf = _rand(gen, C, N, dtype=dtype)
    srcs, w = _mix_table(gen, C)
    ref = gather_mix_ref(buf, srcs, w)
    before = gather_mix.launches
    for s in (srcs, srcs.cpu().numpy()):
        out = gather_mix(buf, s, w)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == (C, N)
        torch.testing.assert_close(out.float(), ref.float(), **_mix_tol(buf))
    assert gather_mix.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,N", [(8, 4096), (8, 1001), (33, 999), (200, 1000)])
def test_gather_mix_output_may_alias_the_input(cuda, C, N, dtype):
    """An out that is the input gives the out-of-place result bit for
    bit; a separate out is written and returned."""
    gen = torch.Generator(device=cuda).manual_seed(N)
    buf = _rand(gen, C, N, dtype=dtype)
    srcs, w = _mix_table(gen, C)
    out = torch.full_like(buf, float("nan"))
    assert gather_mix(buf, srcs, w, out=out) is out
    inplace = buf.clone()
    assert gather_mix(inplace, srcs, w, out=inplace) is inplace
    torch.cuda.synchronize()
    assert torch.equal(inplace, out)


def test_gather_mix_identity_rows_keep_their_row(cuda):
    """A row whose only weight is 1 on itself comes back unchanged."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    buf = _rand(gen, 8, 5000)
    srcs, w = _mix_table(gen, 8)
    w[3] = 0.0
    w[3, 0] = 1.0
    out = gather_mix(buf, srcs, w)
    assert torch.equal(out[3], buf[3])


def test_gather_mix_rejects_bad_layouts(cuda):
    srcs = np.zeros((4, 2), np.int64)
    w = torch.ones((4, 2), device=cuda)
    buf = torch.zeros((4, 64), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gather_mix(buf.half(), srcs, w)
    with pytest.raises(ValueError, match="contiguous"):
        gather_mix(torch.zeros((64, 4), device=cuda).t(), srcs, w)
    with pytest.raises(ValueError, match="out must be"):
        gather_mix(buf, srcs, w, out=torch.zeros((4, 64), device=cuda,
                                                 dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="weights lie on"):
        gather_mix(buf, srcs, w.cpu())
    with pytest.raises(ValueError, match="out of range"):
        gather_mix(buf, srcs + 4, w)
    big = torch.zeros((225, 8), device=cuda)
    with pytest.raises(ValueError, match="C <= 224"):
        gather_mix(big, np.zeros((225, 1), np.int64), torch.ones((225, 1), device=cuda))


def test_slot_loop_card_matches_cpu(cuda):
    """tiny_lm under SlotTrainLoop with a fail and a join: the same alive
    sequence, losses within 1e-4 relative, and gather_mix once a round."""
    from repro_torch.core.ndmp import Simulator
    from repro_torch.dist.flat import tree_map
    from repro_torch.launch.steps import dfl_local_step
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import sgd
    from repro_torch.overlay.controller import OverlayController
    from repro_torch.overlay.events import ChurnTrace
    from repro_torch.runtime.loop import SlotTrainLoop
    cfg = tiny_lm(layers=2)
    runs = []
    for device in ("cpu", cuda):
        sim = Simulator(num_spaces=2, latency=0.05, heartbeat_period=0.5,
                        probe_period=1.0, seed=0)
        sim.seed_network(list(range(5)))

        def make_batch(ids, step, device=device):
            t = torch.from_numpy(np.stack([np.random.default_rng([u, step]).integers(
                0, cfg.vocab_size, (1, 33)) for u in ids])).to(device)
            return {"tokens": t[..., :-1], "labels": t[..., 1:]}
        loop = SlotTrainLoop(
            OverlayController(sim, capacity=6, fuse="flat", flat_io=True),
            local_step=dfl_local_step(cfg, sgd(0.05)), optimizer=sgd(0.05),
            make_params=lambda u, device=device: tree_map(
                lambda l: l.to(device),
                init_params(cfg, torch.Generator().manual_seed(u))),
            make_batch=make_batch)
        before = gather_mix.launches
        recs = loop.run(5, trace=ChurnTrace.scripted([(1.5, "fail", 2),
                                                      (2.5, "join", 9, 0)]))
        runs.append(([r.num_alive for r in recs], [r.loss for r in recs],
                     gather_mix.launches - before))
    (a_cpu, l_cpu, n_cpu), (a_gpu, l_gpu, n_gpu) = runs
    assert a_cpu == a_gpu == [5, 4, 5, 5, 5]
    assert (n_cpu, n_gpu) == (0, 5)
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
