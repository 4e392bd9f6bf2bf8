"""The port on the card: the CUDA ``flash_decode``, ``gather_mix``,
``mix_accumulate``, ``quantize_block``, ``dequantize_block``,
``gather_mix_int8``, ``dequant_accumulate``, ``ssd_scan`` and
``weighted_mix`` kernels against their plain PyTorch versions, and the
serving and slot training loops (codec-free and under the block codecs),
the Mamba2 prefill, the DFL engine over its three tasks, the training
front door's step, and the churn, degraded and cohort rounds
(``ChurnTrainLoop``, ``SlotTrainLoop`` under a ``ChaosEngine``,
``CohortStreamLoop``) on the card against the same on the CPU.  Every test
here needs an NVIDIA GPU and skips without one; the file imports neither JAX nor the
reference package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import tiny_lm
from repro_torch.kernels import flash_decode as fd_module
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.gather_mix import GATHER_MAX_C, gather_mix
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


DTYPE_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]


def _decode_case(gen, B, Hq, Hkv, hd, L, q_dtype=torch.float32,
                 kv_dtype=torch.float32):
    return (_rand(gen, B, Hq, hd, dtype=q_dtype),
            _rand(gen, B, L, Hkv, hd, dtype=kv_dtype),
            _rand(gen, B, L, Hkv, hd, dtype=kv_dtype))


def _check_decode(q, k, v, pos):
    """One launch, held to the plain version; empty rows exactly 0."""
    before = flash_decode.launches
    out = flash_decode(q, k, v, pos)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    assert out.dtype == q.dtype
    ref = flash_decode_ref(q, k, v, pos)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(ref))
    pos = torch.as_tensor(pos).reshape(-1).expand(q.shape[0])
    for b in (pos < 0).nonzero().flatten().tolist():
        assert torch.all(out[b] == 0)
    return out


@pytest.mark.parametrize("q_dtype,kv_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8, 16])
def test_kernel_group_widths_and_dtypes(cuda, G, hd, q_dtype, kv_dtype):
    gen = torch.Generator(device=cuda).manual_seed(G * hd)
    q, k, v = _decode_case(gen, 3, 2 * G, 2, hd, 300, q_dtype, kv_dtype)
    pos = torch.tensor([299, 40, -1], dtype=torch.int32, device=cuda)
    _check_decode(q, k, v, pos)


@pytest.mark.parametrize("L,pos", [(1, [0, -1, 5]), (33, [32, 31, 0]),
                                   (95, [94, 64, 200]), (1000, [999, 500, 33])])
def test_kernel_short_and_ragged_caches(cuda, L, pos):
    """L = 1 and lengths that are no multiple of the 32-row tile."""
    gen = torch.Generator(device=cuda).manual_seed(L)
    for kv_dtype in (torch.float32, torch.bfloat16):
        q, k, v = _decode_case(gen, 3, 8, 2, 64, L, torch.float32, kv_dtype)
        _check_decode(q, k, v, torch.tensor(pos, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_kernel_pos_on_span_edges(cuda, delta):
    """One (b, KV head) whose valid rows are the grid's blocks times the
    tile (every span one whole tile), one row fewer and one more; and a
    row whose spans end on tile edges beside a short one."""
    n_blocks = fd_module.grid_blocks(1, 1, 1 << 20, fd_module._sm_count(cuda.index or 0),
                                     fd_module.blocks_per_sm(4, 4))
    L = n_blocks * fd_module.TILE_ROWS + 2
    gen = torch.Generator(device=cuda).manual_seed(L + delta)
    q, k, v = _decode_case(gen, 1, 4, 1, 128, L)
    pos = n_blocks * fd_module.TILE_ROWS - 1 + delta
    spans = fd_module.partition([pos], 1, L, n_blocks)
    if delta == 0:
        assert all(r1 - r0 == fd_module.TILE_ROWS for _, _, r0, r1, _, _ in spans)
    _check_decode(q, k, v, pos)
    q, k, v = _decode_case(gen, 2, 6, 2, 64, 4096, torch.bfloat16, torch.bfloat16)
    _check_decode(q, k, v, torch.tensor([4095, fd_module.TILE_ROWS - 1 + delta],
                                        dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("dtype,hd,offset", [(torch.bfloat16, 128, 4),
                                             (torch.float32, 32, 1),
                                             (torch.bfloat16, 32, 1)])
def test_kernel_reads_rows_on_narrow_boundaries(cuda, dtype, hd, offset):
    """Rows that start on 8, 4 or 2 bytes (views ``offset`` elements into
    a wider last axis): copied in narrower words, or by plain loads."""
    gen = torch.Generator(device=cuda).manual_seed(hd + offset)
    k = _rand(gen, 3, 200, 2, hd + 8, dtype=dtype)[..., offset:offset + hd]
    v = _rand(gen, 3, 200, 2, hd + 8, dtype=dtype)[..., offset:offset + hd]
    q = _rand(gen, 3, 6, hd, dtype=dtype)
    _check_decode(q, k, v, torch.tensor([199, 70, -1], dtype=torch.int32, device=cuda))


def test_kernel_all_slots_empty(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = _decode_case(gen, 8, 24, 8, 128, 576)
    out = _check_decode(q, k, v, torch.full((8,), -1, dtype=torch.int32, device=cuda))
    assert torch.all(out == 0)


def test_kernel_one_live_slot_among_empty(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    for kv_dtype in (torch.float32, torch.bfloat16):
        q, k, v = _decode_case(gen, 16, 24, 8, 128, 2048, kv_dtype, kv_dtype)
        pos = torch.full((16,), -1, dtype=torch.int32, device=cuda)
        pos[5] = 1999
        _check_decode(q, k, v, pos)


def test_kernel_reads_a_layer_of_a_5d_cache(cuda):
    """The serving loop passes ``cache["k"][i]``, a layer's view of a
    (layers, B, L, Hkv, hd) buffer, read in place."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    kc = _rand(gen, 4, 8, 576, 8, 128)
    vc = _rand(gen, 4, 8, 576, 8, 128)
    q = _rand(gen, 8, 24, 128)
    pos = torch.tensor([-1, 100, 575, -1, 63, 64, 511, 300], dtype=torch.int32,
                       device=cuda)
    for i in range(kc.shape[0]):
        _check_decode(q, kc[i], vc[i], pos)


def test_kernel_same_bits_twice(cuda):
    """Spans merge in span order, whatever order the blocks finish in,
    and the tickets are back at 0 after each call."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _decode_case(gen, 4, 24, 8, 128, 8192, dtype, dtype)
        pos = torch.tensor([8191, 3000, -1, 20000], dtype=torch.int32, device=cuda)
        a = flash_decode(q, k, v, pos)
        b = flash_decode(q, k, v, pos)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        stream = torch.cuda.current_stream(cuda).cuda_stream
        ticket = fd_module._SCRATCH[(cuda.index or 0, stream)][1]
        assert torch.all(ticket == 0)


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
#: gather_mix's shapes: MIX_SHAPES (gather_mix_int8's too), the cohort
#: round's C 128 at N 50,890 (f32 rows 8 bytes past a 16-byte boundary
#: every other row) and one more, C above gather_mix_int8's 224, and C at
#: the gather body's limit
GATHER_SHAPES = MIX_SHAPES + [(128, 50_890), (128, 50_891), (300, 1001),
                              (GATHER_MAX_C, 33)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,N", GATHER_SHAPES)
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
@pytest.mark.parametrize("C,N", [(8, 4096), (8, 1001), (33, 999), (200, 1000), (128, 50_890),
                                 (128, 50_891), (300, 1001), (GATHER_MAX_C, 33)])
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
    C = GATHER_MAX_C + 1
    big = torch.zeros((C, 8), device=cuda)
    with pytest.raises(ValueError, match=f"C <= {GATHER_MAX_C}"):
        gather_mix(big, np.zeros((C, 1), np.int64), torch.ones((C, 1), device=cuda))


@pytest.mark.parametrize("bad", [-1, 64, 1 << 20, (1 << 32) + 5])
def test_gather_mix_drops_a_device_source_outside_the_table(cuda, bad):
    """A device source outside [0, C) is the caller's contract; the gather
    body drops that term (as the reference's scatter drops an index >= C)
    and reads nothing outside its staged tile; an int64 source past int32
    is dropped too, not wrapped into the table."""
    gen = torch.Generator(device=cuda).manual_seed(bad & 0xffff)
    buf = _rand(gen, 64, 1001)
    srcs, w = _mix_table(gen, 64, 7)
    srcs[5, 3] = bad
    kept = srcs.clone()
    kept[5, 3] = 0
    dropped = w.clone()
    dropped[5, 3] = 0.0
    out = gather_mix(buf, srcs, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, gather_mix_ref(buf, kept, dropped), **_mix_tol(buf))


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


# --------------------------------------------------------------------------
# mix_accumulate and the wire codec's kernels
# --------------------------------------------------------------------------

def _bits(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def _wire_rows(gen, B, N, levels, block):
    """Rows of mixed magnitude; row 0 starts with an all-zero block, a
    block of exact .5 ties and a block with a subnormal scale."""
    x = _rand(gen, B, N) * torch.logspace(-3, 1, B, device=gen.device)[:, None]
    if N >= 3 * block:
        k = torch.arange(block, device=gen.device, dtype=torch.float32)
        tie = (k % 7) * 0.5 + 0.25
        tie[0] = levels / 2
        x[0, :block] = 0.0
        x[0, block:2 * block] = tie * torch.where(k % 2 == 1, -1.0, 1.0)
        x[0, 2 * block:3 * block] = 1e-37 * torch.linspace(-1, 1, block,
                                                            device=gen.device)
    return x


@pytest.mark.parametrize("levels", [127, 7])
@pytest.mark.parametrize("block", [128, 64, 32])
@pytest.mark.parametrize("N", [1, 1000, 4133, 3 * 128 * 64])
def test_quantize_and_dequantize_match_plain_bit_for_bit(cuda, levels, block, N):
    """IEEE arithmetic on both sides, subnormals kept: q, the scales, the
    residual (also written over the input) and the decode bit for bit,
    also into an N-wide out, which gets the first N columns."""
    from repro_torch.kernels.ref import dequantize_block_ref, quantize_block_ref
    from repro_torch.kernels.wire_codec import dequantize_block, quantize_block
    gen = torch.Generator(device=cuda).manual_seed(N + block + levels)
    x = _wire_rows(gen, 4, N, levels, block)
    qr, sr, rr = quantize_block_ref(x, block, levels, True)
    before = quantize_block.launches
    q, s, r = quantize_block(x, block=block, levels=levels, with_residual=True)
    xi = x.clone()
    quantize_block(xi, block=block, levels=levels, with_residual=True, residual_out=xi)
    d = dequantize_block(q, s, block=block)
    torch.cuda.synchronize()
    assert quantize_block.launches == before + 2
    assert torch.equal(q, qr) and torch.equal(_bits(s), _bits(sr))
    assert torch.equal(_bits(r), _bits(rr)) and torch.equal(_bits(xi), _bits(rr))
    assert torch.equal(_bits(d), _bits(dequantize_block_ref(q, s, block)))
    narrow = torch.empty((4, N), device=cuda)
    assert dequantize_block(q, s, block=block, out=narrow) is narrow
    torch.cuda.synchronize()
    assert torch.equal(_bits(narrow), _bits(d[:, :N]))


@pytest.mark.parametrize("block", [128, 32])
@pytest.mark.parametrize("C,N", MIX_SHAPES)
def test_gather_mix_int8_matches_plain(cuda, C, N, block):
    """Within 1e-6 x max|dequant| (f32 sums in another order); numpy and
    tensor sources; an N-wide out gets the first N columns."""
    from repro_torch.kernels.ref import dequantize_block_ref, gather_mix_int8_ref
    from repro_torch.kernels.wire_codec import gather_mix_int8, quantize_block
    gen = torch.Generator(device=cuda).manual_seed(C * 31 + N)
    q, s = quantize_block(_rand(gen, C, N), block=block)
    srcs, w = _mix_table(gen, C)
    ref = gather_mix_int8_ref(q, s, srcs, w, block)
    tol = 1e-6 * dequantize_block_ref(q, s, block).abs().max().item()
    for src in (srcs, srcs.cpu().numpy()):
        out = gather_mix_int8(q, s, src, w, block=block)
        torch.testing.assert_close(out, ref, rtol=0.0, atol=tol)
    narrow = torch.empty((C, N), device=cuda)
    assert gather_mix_int8(q, s, srcs, w, block=block, out=narrow) is narrow
    torch.cuda.synchronize()
    assert torch.equal(narrow, out[:, :N])


@pytest.mark.parametrize("acc_dtype,x_dtype", [(torch.float32, torch.float32),
                                               (torch.bfloat16, torch.bfloat16),
                                               (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("N", [1, 1001, 4096, 3 * 2 ** 16 + 5])
def test_mix_accumulate_matches_plain(cuda, acc_dtype, x_dtype, N):
    """Both forms bit for bit (the kernel's fused multiply-add and the
    plain version's exact sum both round once to f32); in place into acc
    and into x with the same bits."""
    from repro_torch.kernels.mix_accumulate import mix_accumulate
    from repro_torch.kernels.ref import mix_accumulate_ref
    gen = torch.Generator(device=cuda).manual_seed(N)
    acc, x = _rand(gen, 6, N, dtype=acc_dtype), _rand(gen, 6, N, dtype=x_dtype)
    w = torch.rand((6,), generator=gen, device=cuda)
    out, ref = mix_accumulate(acc, x, w), mix_accumulate_ref(acc, x, w)
    assert torch.equal(_bits(out), _bits(ref))
    a = acc.clone()
    assert torch.equal(_bits(mix_accumulate(a, x, w, out=a)), _bits(out))
    if acc_dtype == x_dtype:
        xi = x.clone()
        assert torch.equal(_bits(mix_accumulate(acc, xi, w, out=xi)), _bits(out))
    init = mix_accumulate(None, x, w)
    assert init.dtype == x_dtype
    assert torch.equal(_bits(init), _bits(mix_accumulate_ref(None, x, w)))


def test_wire_kernels_reject_bad_layouts(cuda):
    from repro_torch.kernels.mix_accumulate import mix_accumulate
    from repro_torch.kernels.wire_codec import (dequantize_block, gather_mix_int8,
                                                quantize_block)
    x = torch.zeros((4, 256), device=cuda)
    with pytest.raises(ValueError, match="block"):
        quantize_block(x, block=96)
    with pytest.raises(ValueError, match="float32"):
        quantize_block(x.bfloat16())
    with pytest.raises(ValueError, match="levels up to 127"):
        quantize_block(x, levels=200)
    q, s = quantize_block(x)
    with pytest.raises(ValueError, match="contiguous"):
        dequantize_block(torch.zeros((256, 4), dtype=torch.int8, device=cuda).t(), s)
    with pytest.raises(ValueError, match="C <= 224"):
        gather_mix_int8(torch.zeros((225, 128), dtype=torch.int8, device=cuda),
                        torch.zeros((225, 1), dtype=torch.bfloat16, device=cuda),
                        np.zeros((225, 1), np.int64), torch.ones((225, 1), device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mix_accumulate(None, x.half(), torch.ones(4, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        mix_accumulate(None, torch.zeros((256, 4), device=cuda).t(),
                       torch.ones(4, device=cuda))


def _recording(controller_cls, calls):
    """``controller_cls`` with a mixer that records each round's buffer,
    residual before, mask and residual after, as copies on the device."""
    class Recording(controller_cls):
        @property
        def mixer(self):
            inner = super().mixer

            def run(buf, mask, residual, **kw):
                seen = (buf.clone(), residual.clone(), np.array(mask))
                out, res = inner(buf, mask, residual, **kw)
                calls.append(seen + (res.clone(),))
                return out, res
            return run
    return Recording


@pytest.mark.parametrize("codec", ["int8-block", "int4-block"])
def test_codec_slot_loop_card_matches_cpu(cuda, codec):
    """tiny_lm under SlotTrainLoop with a block codec, a fail and a join:
    the same alive sequence, losses within 1e-4 relative, and the kernels
    launched once a round (int8-block: quantize_block, gather_mix_int8,
    mix_accumulate; int4-block: quantize_block, dequantize_block,
    gather_mix, mix_accumulate).  On each device, every round, bit for
    bit: a live row's residual afterwards is the plain version's
    quantization residual of its operand buf + residual, a masked row
    keeps its residual, and a round starts from the residual the last
    round left, except the rows its plan reset, which are zero.  Between
    the devices, each round's encoding is the same: the entries whose q
    or block scale differ between the two operands are at most 1 in 10^3
    of the live entries.  The operands differ in their last bits (the
    local steps sum in other orders), which flips a q only for an entry
    that close to a rounding boundary, and a flip moves the neighbours'
    next operands in that column by a fraction of a step, so flips spread
    along their columns over the rounds; a residual that is not carried,
    or carried in the wrong rows, moves the operand by up to half a step
    and flips about half the q."""
    from repro_torch.core.ndmp import Simulator
    from repro_torch.dist.flat import tree_map
    from repro_torch.kernels.mix_accumulate import mix_accumulate
    from repro_torch.kernels.ref import quantize_block_ref
    from repro_torch.kernels.wire_codec import (dequantize_block, gather_mix_int8,
                                                quantize_block)
    from repro_torch.launch.steps import dfl_local_step
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import sgd
    from repro_torch.overlay.controller import OverlayController
    from repro_torch.overlay.events import ChurnTrace
    from repro_torch.runtime.loop import SlotTrainLoop
    from repro_torch.runtime.slots import plan_reset_slots
    from repro_torch.wire.codec import get_codec
    cfg = tiny_lm(layers=2)
    levels = get_codec(codec).levels
    kernels = (quantize_block, gather_mix_int8, dequantize_block, gather_mix,
               mix_accumulate)
    runs = []
    for device in ("cpu", cuda):
        sim = Simulator(num_spaces=2, latency=0.05, heartbeat_period=0.5,
                        probe_period=1.0, seed=0)
        sim.seed_network(list(range(5)))
        calls, resets = [], {}

        class Loop(SlotTrainLoop):
            def _apply_plan(self, plan, calls=calls, resets=resets):
                resets[len(calls)] = plan_reset_slots(plan)
                return super()._apply_plan(plan)

        def make_batch(ids, step, device=device):
            t = torch.from_numpy(np.stack([np.random.default_rng([u, step]).integers(
                0, cfg.vocab_size, (1, 33)) for u in ids])).to(device)
            return {"tokens": t[..., :-1], "labels": t[..., 1:]}
        loop = Loop(
            _recording(OverlayController, calls)(sim, capacity=6, fuse="flat",
                                                 flat_io=True, codec=codec),
            local_step=dfl_local_step(cfg, sgd(0.05)), optimizer=sgd(0.05),
            make_params=lambda u, device=device: tree_map(
                lambda l: l.to(device),
                init_params(cfg, torch.Generator().manual_seed(u))),
            make_batch=make_batch)
        before = [k.launches for k in kernels]
        recs = loop.run(5, trace=ChurnTrace.scripted([(1.5, "fail", 2),
                                                      (2.5, "join", 9, 0)]))
        runs.append(([r.num_alive for r in recs], [r.loss for r in recs],
                     [k.launches - b for k, b in zip(kernels, before)], calls))
        assert set(resets) == {1, 2}
        prev = None
        for t, (buf, rin, mask, rout) in enumerate(calls):
            live = torch.as_tensor(mask > 0, device=buf.device)[:, None]
            fresh = quantize_block_ref(buf + rin, 128, levels, True)[2]
            assert torch.equal(_bits(rout), _bits(torch.where(live, fresh, rin)))
            if prev is not None:
                carried = prev.clone()
                carried[list(resets.get(t, ()))] = 0.0
                assert torch.equal(_bits(rin), _bits(carried))
            prev = rout
        assert torch.equal(_bits(loop.residual), _bits(prev))
    (a_cpu, l_cpu, n_cpu, c_cpu), (a_gpu, l_gpu, n_gpu, c_gpu) = runs
    assert a_cpu == a_gpu == [5, 4, 5, 5, 5]
    assert n_cpu == [0] * 5
    assert n_gpu == ([5, 5, 0, 0, 5] if codec == "int8-block" else [5, 0, 5, 5, 5])
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
    for (bc, rc, mc, _), (bg, rg, mg, _) in zip(c_cpu, c_gpu):
        np.testing.assert_array_equal(mc, mg)
        qc, sc = quantize_block_ref(bc + rc, 128, levels)
        qg, sg = quantize_block_ref((bg + rg).cpu(), 128, levels)
        differ = ((qc != qg)
                  | (sc != sg).repeat_interleave(128, dim=1))[torch.from_numpy(mc > 0)]
        assert int(differ.sum()) <= 1e-3 * differ.numel()


# --------------------------------------------------------------------------
# dequant_accumulate and the per-rank mixer
# --------------------------------------------------------------------------

DEQ_SHAPES = [(1, 1), (3, 1000), (4, 4133), (8, 4096), (5, 3 * 128 * 64 + 1),
              (3000, 256), (65535, 32)]


@pytest.mark.parametrize("block", [128, 64, 32])
@pytest.mark.parametrize("B,N", DEQ_SHAPES)
def test_dequant_accumulate_matches_plain_bit_for_bit(cuda, block, B, N):
    """f32 and bf16 acc of N columns against the wire's NB·block (ragged
    and whole), in place into acc, an acc off the 16-byte grid, and the
    init form over the full wire width: bit for bit with the plain
    version, which rounds the sum once as the kernel's fmaf does (scales
    include subnormal ones where N allows)."""
    from repro_torch.kernels.ref import dequant_accumulate_ref
    from repro_torch.kernels.wire_codec import dequant_accumulate, quantize_block
    gen = torch.Generator(device=cuda).manual_seed(B * 7 + N + block)
    q, s = quantize_block(_wire_rows(gen, B, N, 127, block), block=block)
    w = torch.rand((B,), generator=gen, device=cuda)
    before = dequant_accumulate.launches
    for dtype in (torch.float32, torch.bfloat16):
        acc = _rand(gen, B, N, dtype=dtype)
        out = dequant_accumulate(acc, q, s, w, block=block)
        ref = dequant_accumulate_ref(acc, q, s, w, block)
        assert out.dtype == dtype and torch.equal(_bits(out), _bits(ref))
        a = acc.clone()
        assert dequant_accumulate(a, q, s, w, block=block, out=a) is a
        assert torch.equal(_bits(a), _bits(ref))
        off = torch.empty(B * N + 1, dtype=dtype, device=cuda)[1:].view(B, N)
        off.copy_(acc)
        assert torch.equal(_bits(dequant_accumulate(off, q, s, w, block=block)),
                           _bits(ref))
    init = dequant_accumulate(None, q, s, w, block=block)
    torch.cuda.synchronize()
    assert init.shape == q.shape and init.dtype == torch.float32
    assert torch.equal(_bits(init), _bits(dequant_accumulate_ref(None, q, s, w, block)))
    assert dequant_accumulate.launches == before + 7


def test_dequant_accumulate_rounds_once_on_the_card(cuda):
    """The sum whose float64 rounding lands on an f32 midpoint
    (tests/test_torch_wire.py): the kernel's fmaf and the plain version
    both give 2^31 + 256."""
    from repro_torch.kernels.ref import dequant_accumulate_ref
    from repro_torch.kernels.wire_codec import dequant_accumulate
    q = torch.zeros((1, 128), dtype=torch.int8, device=cuda)
    q[0, 0] = 65
    s = torch.full((1, 1), 149 * 2.0 ** -7, device=cuda).bfloat16()
    w = torch.tensor([14190909 * 2.0 ** -23], device=cuda)
    acc = torch.full((1, 128), 2.0 ** 31, device=cuda)
    got = dequant_accumulate(acc, q, s, w)
    assert float(got[0, 0]) == float(dequant_accumulate_ref(acc, q, s, w)[0, 0]) \
        == 2.0 ** 31 + 256


def test_dequant_accumulate_rejects_bad_layouts(cuda):
    from repro_torch.kernels.wire_codec import dequant_accumulate
    q = torch.zeros((4, 256), dtype=torch.int8, device=cuda)
    s = torch.zeros((4, 2), dtype=torch.bfloat16, device=cuda)
    w = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="block"):
        dequant_accumulate(None, torch.zeros((4, 256 * 3), dtype=torch.int8, device=cuda),
                           torch.zeros((4, 8), dtype=torch.bfloat16, device=cuda), w,
                           block=96)
    with pytest.raises(ValueError, match="int8 q"):
        dequant_accumulate(None, q.int(), s, w)
    with pytest.raises(ValueError, match="int8 q"):
        dequant_accumulate(torch.zeros((4, 256), dtype=torch.half, device=cuda), q, s, w)
    with pytest.raises(ValueError, match="contiguous"):
        dequant_accumulate(torch.zeros((256, 4), device=cuda).t(), q, s, w)
    with pytest.raises(ValueError, match="65535"):
        dequant_accumulate(None, torch.zeros((65536, 32), dtype=torch.int8, device=cuda),
                           torch.zeros((65536, 1), dtype=torch.bfloat16, device=cuda),
                           torch.ones(65536, device=cuda), block=32)
    with pytest.raises(ValueError, match="lies on"):
        dequant_accumulate(None, q, s.cpu(), w)
    with pytest.raises(ValueError, match="exceeds wire width"):
        dequant_accumulate(torch.zeros((4, 257), device=cuda), q, s, w)


@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL group on the card, left at the module's end."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL runs on the card")
    import socket
    from repro_torch.launch.mesh import make_client_mesh
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mesh = make_client_mesh(0, 1, f"tcp://127.0.0.1:{port}", device="cuda",
                            timeout_s=120)
    yield mesh
    mesh.close()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("codec", [None, "none", "bf16", "int8-block", "int4-block", "topk"])
def test_per_rank_round_card_matches_cpu(cuda, nccl_mesh, codec, masked):
    """One per-rank fedlay round of 8 clients on a one-rank NCCL group (all
    edges are intra-rank takes) on the card against the same round on the
    CPU: the output within 1e-6 x max|X| (the mask's weights are f32
    sums and quotients on two devices), the residual bit for bit (the same
    quantization, or the same top-k set), masked-out rows kept; with
    int8-block each of the 2L = 4 slots folds through one
    dequant_accumulate launch, after one quantize_block and one
    self-term mix_accumulate."""
    from repro_torch.core.mixing import build_permute_schedule
    from repro_torch.dist.sync import fedlay_mix, make_mixer
    from repro_torch.kernels.mix_accumulate import mix_accumulate
    from repro_torch.kernels.wire_codec import dequant_accumulate, quantize_block
    from repro_torch.wire.codec import get_codec
    rng = np.random.default_rng(len(str(codec)) + masked)
    C, sched = 8, build_permute_schedule(8, 2)
    X = {"a": rng.normal(size=(C, 37, 11)).astype(np.float32),
         "b": rng.normal(size=(C, 3000)).astype(np.float32)}
    ef = codec is not None and get_codec(codec).error_feedback
    N = 512 + 3072
    R = (rng.normal(size=(C, N)) * 0.01).astype(np.float32)
    mask = np.ones(C, np.float32)
    mask[[2, 5]] = 0.0
    runs = []
    for device in ("cpu", cuda):
        tree = {k: torch.from_numpy(v).to(device) for k, v in X.items()}
        res = torch.from_numpy(R.copy()).to(device)
        counts = [k.launches for k in (dequant_accumulate, quantize_block, mix_accumulate)]
        if masked:
            got = fedlay_mix(tree, sched, sched.weights, sched.self_weight,
                             nccl_mesh.group, mask=mask, fuse="flat", codec=codec,
                             residual=res if ef else None)
        else:
            mixer = make_mixer("fedlay", sched, nccl_mesh.group, C, clients_per_device=C,
                               fuse="flat", codec=codec)
            got = mixer(tree, sched.weights, sched.self_weight, *((res,) if ef else ()))
        got, res = got if ef else (got, None)
        torch.cuda.synchronize()
        counts = [k.launches - c for k, c in
                  zip((dequant_accumulate, quantize_block, mix_accumulate), counts)]
        runs.append(({k: v.cpu() for k, v in got.items()},
                     None if res is None else res.cpu(), counts))
    (cpu, cpu_res, _), (gpu, gpu_res, counts) = runs
    scale = max(np.abs(v).max() for v in X.values())
    for k in X:
        torch.testing.assert_close(gpu[k], cpu[k], rtol=0.0, atol=1e-6 * scale)
        if masked:
            assert torch.equal(gpu[k][mask == 0], torch.from_numpy(X[k][mask == 0]))
    if ef:
        assert torch.equal(_bits(gpu_res), _bits(cpu_res))
    if codec == "int8-block":
        assert counts == [4, 1, 1]


@pytest.mark.parametrize("codec", [None, "int8-block"])
def test_make_dfl_step_card_matches_cpu(cuda, nccl_mesh, codec):
    """launch/train.py's make_dfl_step at tiny_lm's width (2 layers): 4
    clients from the same parameters on the one-rank NCCL group, three
    AdamW(3e-3) steps of the flat round (codec-free, or int8-block with
    its residual) on the card against the same steps on the CPU (a gloo
    group over the same rank).

    * Each step's loss within 1e-4 relative (f32 on both, sums in other
      orders).
    * The card's last mixing round against the CPU's round from the same
      inputs (the card's parameters and residual as the round read
      them): the output within 1e-6 x max|buf|, the residual bit for bit,
      as ``test_per_rank_round_card_matches_cpu`` holds one round.  A
      round that dropped a neighbour or misweighted a row fails this.
    * The final (G, N) parameters, and under int8-block the residual,
      within 1e-5 x max|p|, but for a share of the elements that are
      within 2 lr a step and, under int8-block, one quantization step
      (max|p| / 127): at most 1e-3 of them codec-free (AdamW normalizes
      each gradient component by its own size, so where one is near 0
      its f32 rounding on the two devices can move its update by up to
      2 lr), at most 1e-2 under int8-block (an operand within rounding
      of a quantization boundary rounds to either side, which moves that
      parameter a whole step, and the next local step spreads the
      difference through the client's gradients: 0.20 % of the elements
      on the card's first run).

    Each step launches mix_accumulate 2L + 1 = 5 times codec-free, and
    quantize_block once, dequant_accumulate 2L = 4 times and
    mix_accumulate once under int8-block; AdamW's count is 3; the
    buffers keep their storage."""
    import torch.distributed as dist
    from repro_torch.core.mixing import build_permute_schedule
    from repro_torch.data.tokens import TokenStream
    from repro_torch.dist.sync import make_mixer
    from repro_torch.kernels.mix_accumulate import mix_accumulate
    from repro_torch.kernels.wire_codec import dequant_accumulate, quantize_block
    from repro_torch.launch.train import make_dfl_step, rank_state
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import adamw
    from repro_torch.wire.codec import get_codec
    cfg, G, L, lr, steps = tiny_lm(layers=2), 4, 2, 3e-3, 3
    sched = build_permute_schedule(G, L)
    wire = get_codec(codec)
    ef = wire is not None
    gloo = dist.new_group(backend="gloo")
    kernels = (mix_accumulate, quantize_block, dequant_accumulate)
    runs, mixers = [], []
    try:
        for device, group in (("cpu", gloo), (cuda, nccl_mesh.group)):
            opt = adamw(lr, weight_decay=0.0)
            p0 = init_params(cfg, torch.Generator().manual_seed(5))
            state = rank_state(p0, G, opt, flat=True, codec=wire, error_feedback=ef,
                               device=device)
            ptrs = state.buffers()
            mixer = make_mixer("fedlay", sched, group, G, clients_per_device=G,
                               fuse="flat", codec=codec)
            mixers.append(mixer)
            seen = {}

            def keep_inputs(*args, _mixer=mixer, _seen=seen, **kw):
                # the round's inputs, before it runs (the last step's stay)
                _seen["buf"] = kw["buf"].to("cpu", copy=True)
                _seen["res"] = args[3].to("cpu", copy=True) if ef else None
                return _mixer(*args, **kw)

            step = make_dfl_step(cfg, opt, keep_inputs, group, error_feedback=ef)
            streams = [iter(TokenStream(cfg.vocab_size, 2, 64, seed=0, client=c))
                       for c in range(G)]
            w = torch.as_tensor(sched.weights, device=device)
            sw = torch.as_tensor(sched.self_weight, device=device)
            losses, counts = [], []
            for _ in range(steps):
                xs, ys = zip(*(next(s) for s in streams))
                batch = {"tokens": torch.from_numpy(np.stack(xs)).to(device),
                         "labels": torch.from_numpy(np.stack(ys)).to(device)}
                start = [k.launches for k in kernels]
                losses.append(float(step(state, batch, w, sw)))
                counts.append([k.launches - a for k, a in zip(kernels, start)])
            assert state.buffers() == ptrs
            assert state.opt_state["count"].tolist() == [steps] * G
            runs.append((losses, counts, state.params.cpu().numpy(),
                         None if state.residual is None else state.residual.cpu().numpy(),
                         seen, state.spec))
        # the card's last round again, on the CPU from the card's inputs
        *_, gpu_p, gpu_r, seen, spec = runs[1]
        buf, res = seen["buf"], None if seen["res"] is None else seen["res"].clone()
        out = torch.empty_like(buf)
        kw = {"buf": buf, "out": out}
        if ef:
            kw["workspace"] = wire.workspace(G, buf.shape[1], "cpu")
        mixers[0](spec.unravel(buf), torch.as_tensor(sched.weights),
                  torch.as_tensor(sched.self_weight), *((res,) if ef else ()), **kw)
    finally:
        dist.destroy_process_group(gloo)
    (cpu, _, cpu_p, cpu_r, _, _), (gpu, counts, *_) = runs
    np.testing.assert_allclose(gpu, cpu, rtol=1e-4)
    assert counts == [[1, 1, 2 * L] if ef else [2 * L + 1, 0, 0]] * steps
    np.testing.assert_allclose(gpu_p, out.numpy(), rtol=0,
                               atol=1e-6 * float(buf.abs().max()))
    if ef:
        assert torch.equal(_bits(torch.from_numpy(gpu_r)), _bits(res))
    scale = float(np.abs(cpu_p).max())
    bound = 2 * lr * steps + (scale / wire.levels if ef else 0.0)
    share = 1e-2 if ef else 1e-3
    for name, got, want in [("params", gpu_p, cpu_p)] + ([("residual", gpu_r, cpu_r)]
                                                         if ef else []):
        diff = np.abs(got - want)
        off = diff > 1e-5 * scale
        assert off.mean() <= share, (name, int(off.sum()), off.size, float(diff.max()))
        assert not off.any() or diff[off].max() <= bound, (name, float(diff.max()), bound)


# --------------------------------------------------------------------------
# ssd_scan and the Mamba2 serving path
# --------------------------------------------------------------------------

SSD_SHAPES = [(1, 256, 1, 64, 64, 256), (2, 512, 4, 64, 128, 256),
              (1, 96, 3, 128, 64, 256),       # Q = 96: one ragged row tile
              (4, 7, 32, 64, 128, 256),       # Q = 7
              (3, 300, 5, 32, 32, 16),        # Q halves to 4
              (2, 768, 2, 128, 128, 256), (1, 2048, 2, 64, 128, 1024),
              (1, 512, 2, 32, 128, 256), (2, 384, 3, 128, 32, 128),
              (1, 16384, 32, 64, 128, 256),   # 64 chunks at Mamba2's heads
              (2, 512, 7, 64, 128, 256)]      # H 7: no multiple of 2 or 4


def ssd_inputs(gen, B, S, H, P, N, dtype):
    """The mixer's ranges: dt a softplus of N(0, 1), A = −(1..H), x, B and C
    N(0, 1)."""
    dev = gen.device
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=dev))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    return (_rand(gen, B, S, H, P, dtype=dtype), dt, A,
            _rand(gen, B, S, N, dtype=dtype), _rand(gen, B, S, N, dtype=dtype))


def assert_ssd_close(got, ref, dt, A, Q, head_dim):
    """ssd_scan's y (head_dim 2) or final state (head_dim 1) against the
    plain version, head by head: |got - ref| <= rtol·|ref| + (base +
    8·2^-24·cs_h)·max|ref_h|, cs_h the largest |within-chunk cumsum of
    dt·A_h|.  Both sides form each decay exp(cs_i - cs_j) from such a
    cumsum, whose rounding shifts the exponent by a few 2^-24·|cs|; the
    plain version's own error against float64 read at most
    0.6·2^-24·cs_h·max|y_h| on the CPU, and the card's kernel against it
    at most 0.87 (f32) and 1.47 (bf16 state) times 2^-24·cs_h·max|ref_h|
    (PERF.md §6): the factor 8, as in chip_smoke.py, is about 5x the
    largest.  base 1e-5 for f32 sums in
    another order; bf16 y adds 1e-2 (base and rtol) for its one rounding
    to bf16."""
    B, S, H = dt.shape
    cs = (dt * A).reshape(B, S // Q, Q, H).sum(2).abs().amax(dim=(0, 1))
    base, rtol = (1e-2, 1e-2) if got.dtype == torch.bfloat16 else (1e-5, 0.0)
    g, r = got.float().movedim(head_dim, 0), ref.float().movedim(head_dim, 0)
    limit = (base + 8 * 2.0 ** -24 * cs) * r.abs().reshape(H, -1).amax(dim=1)
    excess = ((g - r).abs() - rtol * r.abs()).reshape(H, -1).amax(dim=1) - limit
    assert bool((excess <= 0).all()), excess


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_scan_matches_plain(cuda, B, S, H, P, N, chunk, dtype):
    """y and the final state against the plain chunked version; one
    launch a call."""
    from repro_torch.kernels.ref import chunk_len, ssd_chunked_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    gen = torch.Generator(device=cuda).manual_seed(B * S + H * P + N)
    x, dt, A, Bm, Cm = ssd_inputs(gen, B, S, H, P, N, dtype)
    before = ssd_scan.launches
    out = torch.full((B, H, P, N), float("nan"), device=cuda)
    y, _ = ssd_scan(x, dt, A, Bm, Cm, chunk, state_out=out)
    ref, final = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert y.dtype == dtype and ssd_scan.launches == before + 1
    assert_ssd_close(y, ref, dt, A, chunk_len(S, chunk), 2)
    assert_ssd_close(out, final, dt, A, chunk_len(S, chunk), 1)


def test_ssd_scan_reads_row_strided_views(cuda):
    """x, B and C as the prefill hands them over: slices of one conv output
    with a row stride of d_inner + 2N."""
    from repro_torch.kernels.ref import chunk_len, ssd_chunked_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    gen = torch.Generator(device=cuda).manual_seed(5)
    B, S, H, P, N = 2, 640, 4, 64, 128
    xbc = _rand(gen, B, S, H * P + 2 * N)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=cuda))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=cuda)
    out = torch.empty((B, H, P, N), device=cuda)
    y, _ = ssd_scan(x, dt, A, Bm, Cm, 256, state_out=out)
    ref, final = ssd_chunked_ref(x.contiguous(), dt, A, Bm.contiguous(),
                                 Cm.contiguous(), 256)
    torch.cuda.synchronize()
    Q = chunk_len(S, 256)
    assert Q == 128
    assert_ssd_close(y, ref, dt, A, Q, 2)
    assert_ssd_close(out, final, dt, A, Q, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_reads_odd_row_strides(cuda, dtype):
    """Views whose rows start at odd elements: bf16 pairs that are not
    4-byte aligned, which the kernel copies by plain loads."""
    from repro_torch.kernels.ref import chunk_len, ssd_chunked_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    gen = torch.Generator(device=cuda).manual_seed(6)
    B, S, H, P, N = 2, 640, 4, 64, 128
    xbc = _rand(gen, B, S, H * P + 2 * N + 1, dtype=dtype)
    x = xbc[..., 1:H * P + 1].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P + 1:H * P + N + 1], xbc[..., H * P + N + 1:]
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=cuda))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=cuda)
    out = torch.empty((B, H, P, N), device=cuda)
    y, _ = ssd_scan(x, dt, A, Bm, Cm, 256, state_out=out)
    ref, final = ssd_chunked_ref(x.contiguous(), dt, A, Bm.contiguous(),
                                 Cm.contiguous(), 256)
    torch.cuda.synchronize()
    Q = chunk_len(S, 256)
    assert_ssd_close(y, ref, dt, A, Q, 2)
    assert_ssd_close(out, final, dt, A, Q, 1)


def test_ssd_scan_rejects_bad_layouts(cuda):
    from repro_torch.kernels.ssd_scan import ssd_scan
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, dt, A, Bm, Cm = ssd_inputs(gen, 1, 64, 2, 64, 64, torch.float32)
    with pytest.raises(ValueError, match="headdim"):
        ssd_scan(*ssd_inputs(gen, 1, 64, 2, 16, 64, torch.float32))
    with pytest.raises(ValueError, match="headdim"):
        ssd_scan(*ssd_inputs(gen, 1, 64, 2, 64, 256, torch.float32))
    with pytest.raises(ValueError, match="at most 1024"):
        ssd_scan(*ssd_inputs(gen, 1, 2048, 1, 64, 64, torch.float32), chunk=2048)
    with pytest.raises(ValueError, match="all float32 or all"):
        ssd_scan(x, dt, A, Bm.bfloat16(), Cm)
    with pytest.raises(ValueError, match="float32 dt and A"):
        ssd_scan(x, dt.double(), A, Bm, Cm)
    with pytest.raises(ValueError, match="dense"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="state_out must be"):
        ssd_scan(x, dt, A, Bm, Cm, state_out=torch.empty((1, 2, 64, 64)))


def test_mamba2_run_batch_card_matches_cpu(cuda):
    """The reduced Mamba2-370m (2 layers, headdim 32, d_state 32) served by
    ``run_batch`` on the card and on the CPU from the same weights:
    prefill logits within 1e-4 scaled and states within 1e-5 x max|ref|;
    one ``ssd_scan`` launch a layer."""
    import argparse
    from repro_torch.configs import REGISTRY, reduce_for_smoke
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.serve import run_batch
    from repro_torch.models.model import init_cache, prefill
    cfg = reduce_for_smoke(REGISTRY["mamba2-370m"])
    cpu = LanguageModel(cfg, torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 40)))
    runs = []
    for model in (cpu, gpu):
        cache = init_cache(model, 3, 40)
        before = ssd_scan.launches
        logits, _ = prefill(model, cache, toks.to(model.device))
        runs.append((logits.cpu(), cache["state"].cpu(), ssd_scan.launches - before))
    (lc, sc, nc), (lg, sg, ng) = runs
    assert nc == 0 and ng == cfg.num_layers
    assert (lg - lc).abs().max().item() <= 1e-4 * max(1.0, lc.abs().max().item())
    torch.testing.assert_close(sg, sc, rtol=0.0, atol=1e-5 * sc.abs().max().item())
    res = run_batch(cfg, gpu, argparse.Namespace(batch=2, prompt_len=33, gen=6),
                    np.random.default_rng(0))
    assert res["tok_s"] > 0


# --------------------------------------------------------------------------
# weighted_mix and the DFL engine
# --------------------------------------------------------------------------

#: (K, N), contiguous rows (row stride N): the engine's N 50,890 at K 7,
#: 8, 15, 16 and 17 and 33 (around the kernel's groups of 8 rows and its
#: remainder group), and K 513, one over the host weights carried by value
#: (they go by pointer)
WMIX_SHAPES = [(1, 1), (2, 127), (7, 50_890), (8, 50_890), (15, 50_890), (16, 50_890),
               (17, 50_890), (33, 50_890), (15, 4099), (100, 1000), (513, 1000),
               (3, 2 ** 20 + 3)]


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("masked", [None, "some", "all"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", WMIX_SHAPES)
def test_weighted_mix_matches_plain_bit_for_bit(cuda, K, N, dtype, masked):
    """The kernel against weighted_mix_ref on the card, bit for bit: both
    sum from zero in the order k = 0 … K−1 with each product rounded to
    f32, and both renormalize a mask with the same device operations; an
    all-masked stack is zeros.  The same weights and mask from the host
    (carried in the launch up to K 512, copied beyond) give the same
    bits."""
    from repro_torch.kernels.ref import weighted_mix_ref
    from repro_torch.kernels.weighted_mix import weighted_mix
    gen = torch.Generator(device=cuda).manual_seed(K * 7919 + N)
    models = _rand(gen, K, N, dtype=dtype)
    w = torch.rand((K,), generator=gen, device=cuda)
    mask = None
    if masked is not None:
        mask = (torch.rand((K,), generator=gen, device=cuda) < 0.5).float()
        mask[0] = 1.0
        if masked == "all":
            mask.zero_()
    before = weighted_mix.launches
    out = weighted_mix(models, w, mask=mask)
    host = weighted_mix(models, w.cpu(), mask=None if mask is None else mask.cpu())
    torch.cuda.synchronize()
    assert weighted_mix.launches == before + 2
    ref = weighted_mix_ref(models, w, mask)
    assert out.dtype == dtype and out.shape == (N,)
    assert torch.equal(_bits(out), _bits(ref))
    assert torch.equal(_bits(host), _bits(out))
    if masked == "all":
        assert not out.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weighted_mix_strided_views_and_aliased_out(cuda, dtype):
    """Row-strided views on the 16-byte grid (the vector path, with and
    without a scalar tail), views off it (the scalar path) and an ``out``
    that is one of the rows all give the contiguous copy's result bit for
    bit."""
    from repro_torch.kernels.ref import weighted_mix_ref
    from repro_torch.kernels.weighted_mix import weighted_mix
    gen = torch.Generator(device=cuda).manual_seed(3)
    big = _rand(gen, 12, 3, 5008, dtype=dtype)
    w = torch.rand((6,), generator=gen, device=cuda)
    for view in (big[::2, 1], big[::2, 1, :5005], big[1::2, 2, 1:],
                 big[:6, 0, 3:4003]):
        want = weighted_mix_ref(view.contiguous(), w)
        assert torch.equal(_bits(weighted_mix(view, w)), _bits(want))
        out = weighted_mix(view, w, out=view[2])
        torch.cuda.synchronize()
        assert out.data_ptr() == view[2].data_ptr()
        assert torch.equal(_bits(view[2]), _bits(want))


@pytest.mark.parametrize("dtype,pad", [(torch.float32, 4), (torch.float32, 1),
                                       (torch.float32, 2), (torch.bfloat16, 1),
                                       (torch.bfloat16, 4), (torch.bfloat16, 2),
                                       (torch.bfloat16, 6)])
def test_weighted_mix_row_strides_off_the_grid(cuda, dtype, pad):
    """Rows of the engine's N 50,890 read as a view ``pad`` elements
    narrower than their stride, so that the row stride is 8 (as the
    engine's own rows) or 4 bytes off the 16-byte grid or on it (f32 pads
    4, 1, 2), or 2, 4, 8 bytes off or on it (bf16 pads 1, 4, 2, 6): each
    takes the widest load the layout allows, bit for bit with the plain
    version, with host and device weights, unmasked and masked, and into a
    row of the view."""
    from repro_torch.kernels.ref import weighted_mix_ref
    from repro_torch.kernels.weighted_mix import weighted_mix
    gen = torch.Generator(device=cuda).manual_seed(pad)
    N = 50_890
    for K in (7, 17):
        view = _rand(gen, K, N + pad, dtype=dtype)[:, :N]
        w = torch.rand((K,), generator=gen, device=cuda)
        mask = (torch.rand((K,), generator=gen, device=cuda) < 0.5).float()
        mask[0] = 1.0
        for m in (None, mask):
            want = weighted_mix_ref(view.contiguous(), w, m)
            for weights, mm in ((w, m), (w.cpu(), None if m is None else m.cpu())):
                assert torch.equal(_bits(weighted_mix(view, weights, mask=mm)), _bits(want))
        want = weighted_mix_ref(view.contiguous(), w)
        out = weighted_mix(view, w.cpu(), out=view[3])
        torch.cuda.synchronize()
        assert out.data_ptr() == view[3].data_ptr()
        assert torch.equal(_bits(view[3]), _bits(want))


def test_weighted_mix_rejects_bad_layouts(cuda):
    from repro_torch.kernels.weighted_mix import weighted_mix
    m = torch.zeros((3, 64), device=cuda)
    w = torch.ones((3,), device=cuda)
    with pytest.raises(ValueError, match="at least one model"):
        weighted_mix(torch.zeros((0, 64), device=cuda), torch.ones((0,), device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        weighted_mix(m.half(), w)
    with pytest.raises(ValueError, match="adjacent columns"):
        weighted_mix(torch.zeros((64, 3), device=cuda).t(), w)
    with pytest.raises(ValueError, match="mask on cpu, weights on cuda"):
        weighted_mix(m, w, mask=torch.ones(3))
    with pytest.raises(ValueError, match="mask on cuda:0, weights on cpu"):
        weighted_mix(m, w.cpu(), mask=torch.ones((3,), device=cuda))
    # host weights are the engine's path: accepted, the device weights' bits
    gen = torch.Generator(device=cuda).manual_seed(5)
    models = _rand(gen, 3, 64)
    wr = torch.rand((3,), generator=gen, device=cuda)
    assert torch.equal(_bits(weighted_mix(models, wr.cpu())), _bits(weighted_mix(models, wr)))
    with pytest.raises(ValueError, match="out must be"):
        weighted_mix(m, w, out=torch.zeros((64,), device=cuda, dtype=torch.bfloat16))


def _engine_task(kind, device):
    """A small task of each kind, as tier-1 runs them: the MLP on 12 x 12
    digits, ``benchmarks/common.py``'s cifar and shakespeare sizes."""
    from repro_torch.data import char_lm, cifar_like, mnist_like, shard_partition
    from repro_torch.models.small import CNNTask, LSTMTask, MLPTask
    if kind == "lstm":
        data = char_lm(num_roles=24, stream_len=512, test_len=2048, seed=0)
        return LSTMTask(data, 8, hidden=32, seq=24, local_steps=2, batch=8, device=device)
    if kind == "cnn":
        data = cifar_like(n_train=600, n_test=200, image=8, seed=0)
        part = shard_partition(data.y_train, num_clients=10, shards_per_client=3, seed=0)
        return CNNTask(data, part, channels=8, local_steps=2, batch=32, device=device)
    data = mnist_like(n_train=600, n_test=200, image=12, seed=0)
    part = shard_partition(data.y_train, num_clients=10, shards_per_client=3, seed=0)
    return MLPTask(data, part, hidden=16, local_steps=2, batch=16, device=device)


@pytest.mark.parametrize("kind,method", [
    pytest.param(kind, method, id=method if kind == "mlp" else f"{kind}-{method}")
    for kind in ("mlp", "cnn", "lstm")
    for method in ("fedlay", "fedavg", "gaia", "dfl-dds")])
def test_engine_card_matches_cpu(cuda, kind, method):
    """A small Engine.run on the card against the same call on the CPU
    from the same initial vector, for each of the three tasks: equal
    counters and trace times, trace accuracies within 2 / (number of
    predictions), final models within 1e-5 x max|p| (cuBLAS, cuDNN and the
    CPU round their products differently, and the card's convolution and
    embedding gradients may accumulate in any order), and one weighted_mix
    launch per aggregation on the card and none on the CPU."""
    from repro_torch.core.dfl import Engine
    from repro_torch.kernels.weighted_mix import weighted_mix
    runs = []
    for device in ("cpu", cuda):
        task = _engine_task(kind, device)
        before = weighted_mix.launches
        res = Engine().run(task, method, total_time=4.0, model_bytes=1000, seed=0)
        runs.append((res, weighted_mix.launches - before))
    (rc, lc), (rg, lg) = runs
    assert lc == 0 and lg == rg.aggregations == rc.aggregations > 0
    for field in ("comm_bytes_per_client", "messages_per_client", "suppressed_sends",
                  "local_steps_per_client"):
        assert getattr(rg, field) == getattr(rc, field), field
    assert [r.time for r in rg.trace] == [r.time for r in rc.trace]
    predictions = task._yte.numel()
    for a, b in zip(rg.trace, rc.trace):
        assert np.abs(a.accs - b.accs).max() <= 2 / predictions
    scale = max(p.abs().max().item() for p in rc.final_params)
    for p, q in zip(rg.final_params, rc.final_params):
        assert p.device.type == "cuda"
        assert (p.cpu() - q).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("kind", ["mlp", "cnn", "lstm"])
def test_first_gradient_card_matches_f64(cuda, kind):
    """The first SGD step's gradient on the card against the same on the
    CPU in f64, from the same vector and batch, within 1e-5 of each
    leaf's max|g|: the card's products and convolutions are full f32 (a
    TF32 convolution reads about 1e-4 of a leaf's max)."""
    card, cpu = _engine_task(kind, cuda), _engine_task(kind, "cpu")
    p0 = card.init_params(0)
    idx = card.partition.client_indices[0]
    take = np.random.default_rng(0).choice(idx, size=min(card.batch, len(idx)),
                                           replace=False)
    grads = []
    for task, dtype in ((card, torch.float32), (cpu, torch.float64)):
        x, y = task._batch_of(take)
        x = x.to(dtype) if x.is_floating_point() else x
        p = p0.detach().to(device=task.device, dtype=dtype).requires_grad_(True)
        (g,) = torch.autograd.grad(task._loss(task.unflatten(p), x, y), p)
        grads.append(g.detach().cpu().double())
    got, ref = grads
    for leaf, off, shape in cpu._layout:
        sl = slice(off, off + int(np.prod(shape)))
        top = ref[sl].abs().max().item()
        assert (got[sl] - ref[sl]).abs().max().item() <= 1e-5 * top, leaf


# --------------------------------------------------------------------------
# Churn, faults and scale: the three paths that mix through gather_mix
# --------------------------------------------------------------------------

CHURN_TRACE = [(1.5, "fail", 3), (4.5, "join", 3, 0), (6.5, "join", 70, 0)]


def test_churn_loop_card_matches_cpu(cuda):
    """tiny_lm under ChurnTrainLoop (a fail, the same id's rejoin, a new
    id's join; 8 steps) on the card and on the CPU from the same
    parameters and data: the same records but for the loss, each loss
    within 1e-4 relative (f32 on both, the card sums in other orders),
    and one gather_mix launch a step on the card."""
    from repro_torch.core.ndmp import Simulator
    from repro_torch.dist.flat import tree_map
    from repro_torch.launch.steps import dfl_train_bundle
    from repro_torch.models.config import InputShape
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import sgd
    from repro_torch.overlay import ChurnTrace, ChurnTrainLoop, OverlayController
    cfg = tiny_lm(layers=2)
    runs = []
    for device in ("cpu", cuda):
        sim = Simulator(num_spaces=2, latency=0.05, heartbeat_period=0.5,
                        probe_period=1.0, seed=0)
        sim.seed_network(list(range(6)))
        bundle = dfl_train_bundle(cfg, InputShape("t", 32, 1, "train"), 1, sgd(0.05),
                                  sync="none")
        loop = ChurnTrainLoop(
            OverlayController(sim, fuse="flat"), local_step=bundle.step,
            make_params=lambda u, d=device: tree_map(
                lambda l: l.to(d), init_params(cfg, torch.Generator().manual_seed(u))),
            optimizer=sgd(0.05),
            make_batch=lambda ids, s, d=device: {k: torch.from_numpy(np.stack([
                np.random.default_rng([u, s, i]).integers(0, cfg.vocab_size, (1, 32))
                for u in ids])).to(d) for i, k in enumerate(("tokens", "labels"))})
        before = gather_mix.launches
        recs = loop.run(8, trace=ChurnTrace.scripted(CHURN_TRACE))
        torch.cuda.synchronize()
        runs.append((recs, gather_mix.launches - before))
    (rc, lc), (rg, lg) = runs
    fields = lambda r: (r.num_alive, r.swapped, r.cache_hit, r.joined, r.left)  # noqa: E731
    assert [fields(r) for r in rg] == [fields(r) for r in rc]
    assert any(r.cache_hit and r.joined == (3,) for r in rg)
    assert lc == 0 and lg == 8
    for a, b in zip(rg, rc):
        assert abs(a.loss - b.loss) <= 1e-4 * abs(b.loss)


def test_degraded_slot_loop_card_matches_cpu(cuda):
    """The fault_storm partition arm at its quick size (n 8, 10 % loss,
    a 2-way partition over [2, 14), 2 stragglers, an identity local step)
    with a HealthTracker, 24 rounds, on the card and on the CPU: equal
    edge masks and faults_injected every round, the rows within 1e-6 x
    max|p|, one gather_mix launch a round, no buffer reallocated."""
    from repro_torch.core.ndmp import Simulator
    from repro_torch.faults import (ChaosEngine, FaultPlan, HealthTracker,
                                    Partition, Straggler)
    from repro_torch.obs.rounds import RoundLedger
    from repro_torch.optim.optimizers import sgd
    from repro_torch.overlay import OverlayController
    from repro_torch.runtime.loop import SlotTrainLoop
    from repro_torch.runtime.masked import masked_local_step

    def step(params, opt_state, batch):
        return params, opt_state, {"loss": (params["w"] ** 2).mean(dim=-1)}

    runs = []
    for device in ("cpu", cuda):
        sim = Simulator(num_spaces=2, latency=0.05, heartbeat_period=0.5,
                        probe_period=1.0, seed=0)
        sim.seed_network(list(range(8)))
        plan = FaultPlan(seed=7, msg_loss=0.1, partitions=(
            Partition(2.0, 14.0, (tuple(range(4)), tuple(range(4, 8)))),),
            stragglers=tuple(Straggler(2.0, 18.0, 7 - i) for i in range(2)))
        ledger = RoundLedger()
        loop = SlotTrainLoop(
            OverlayController(ChaosEngine(sim, plan), capacity=8, fuse="flat",
                              flat_io=True),
            local_step=masked_local_step(step),
            make_params=lambda u, d=device: {"w": torch.from_numpy(
                np.random.default_rng(u).normal(size=64).astype(np.float32)).to(d)},
            optimizer=sgd(0.0),
            make_batch=lambda ids, s, d=device: {"x": torch.zeros((len(ids), 1), device=d)},
            ledger=ledger, health=HealthTracker(1.0))
        ptrs = {loop.params.data_ptr(), loop._spare.data_ptr()}
        loop.health.suspect(0, 0.0)
        before = gather_mix.launches
        loop.run(24)
        torch.cuda.synchronize()
        assert {loop.params.data_ptr(), loop._spare.data_ptr()} == ptrs
        runs.append((loop, ledger, gather_mix.launches - before))
    (lc, ledc, nc), (lg, ledg, ng) = runs
    assert nc == 0 and ng == 24
    keys = ("faults_injected", "degraded_edges")
    assert [[r.extra[k] for k in keys] for r in ledg.rows] == \
        [[r.extra[k] for k in keys] for r in ledc.rows]
    assert sum(r.extra["degraded_edges"] for r in ledg.rows) > 0
    want = lc.params
    assert (lg.params.cpu() - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def test_cohort_loop_card_matches_cpu(cuda):
    """CohortStreamLoop at the cohort_stream benchmark's quick size (n
    2000, capacity 32, K 16, dim 256, 8 rounds, a 1 % fail and join burst
    at mid-run) on the card and on the CPU: equal records but for the
    host's remap ms, the rows within 1e-6 x max|buf|, one gather_mix
    launch a round, and the two resident buffers only swap roles."""
    from repro_torch.scale import CohortStreamLoop, VectorSimulator
    runs = []
    for device in ("cpu", cuda):
        sim = VectorSimulator(num_spaces=3, latency=0.05, heartbeat_period=0.5,
                              probe_period=1.0)
        sim.seed_network(range(2000))
        loop = CohortStreamLoop(
            sim, capacity=32, cohort_size=16, seed=3, device=device,
            make_params=lambda u: np.random.default_rng(u).random(256).astype(np.float32))
        ptrs = {loop.buf.data_ptr(), loop.spare.data_ptr()}
        before = gather_mix.launches
        loop.run(4)
        sim.fail_batch(range(20))
        sim.join_batch(range(3000, 3020))
        sim.run_for(30.0)
        loop.run(4)
        torch.cuda.synchronize()
        assert {loop.buf.data_ptr(), loop.spare.data_ptr()} == ptrs
        runs.append((loop, gather_mix.launches - before))
    (lc, nc), (lg, ng) = runs
    assert nc == 0 and ng == 8
    fields = lambda r: (r.round, r.time, r.cohort_size, r.streamed_in,  # noqa: E731
                        r.streamed_out, r.restored, r.donor_seeded, r.fresh, r.evicted)
    assert [fields(r) for r in lg.records] == [fields(r) for r in lc.records]
    assert list(lg.park) == list(lc.park)
    scale = lc.buf.abs().max().item()
    assert (lg.buf.cpu() - lc.buf).abs().max().item() <= 1e-6 * scale


def test_cohort_loop_raises_above_gather_mix_capacity(cuda):
    """On the card the cohort capacity is at most gather_mix's
    GATHER_MAX_C (1,816): one more raises when the loop is built, the
    limit builds and runs a round."""
    from repro_torch.scale import CohortStreamLoop, VectorSimulator
    sim = VectorSimulator(num_spaces=3)
    sim.seed_network(range(300))
    kw = dict(cohort_size=8, make_params=lambda u: np.zeros(4, np.float32), device=cuda)
    with pytest.raises(ValueError, match=f"<= {GATHER_MAX_C}"):
        CohortStreamLoop(sim, capacity=GATHER_MAX_C + 1, **kw)
    CohortStreamLoop(sim, capacity=GATHER_MAX_C, **kw).run(1)
