"""The port's wire codecs against the JAX reference on the CPU: the
kernels' plain paths (``quantize_block``, ``dequantize_block``,
``dequant_accumulate``, ``gather_mix_int8``, ``mix_accumulate``) against
the Pallas kernels in interpret mode, every codec against its reference,
the codec round of ``global_mixer``, and ``SlotTrainLoop`` under
int8-block and int4-block.
Same numpy inputs on both sides; each tolerance is stated where it is
used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mixing import build_permute_schedule as j_build
from repro.core.ndmp import Simulator as JSimulator
from repro.dist.sync import global_mixer as j_global_mixer
from repro.dist.sync import sync_bytes_per_client as j_sync_bytes
from repro.kernels import wire_codec as jwc
from repro.kernels.weighted_mix import mix_accumulate as j_mix_accumulate
from repro.launch.train import tiny_lm as j_tiny_lm
from repro.models.model import init_params as j_init_params
from repro.obs.rounds import RoundLedger as JRoundLedger
from repro.optim import optimizers as jopt
from repro.overlay.controller import OverlayController as JController
from repro.overlay.events import ChurnTrace as JChurnTrace
from repro.runtime.loop import SlotTrainLoop as JSlotTrainLoop
from repro.wire.codec import get_codec as j_get_codec
from repro_torch.configs import tiny_lm as t_tiny_lm
from repro_torch.core.mixing import build_permute_schedule
from repro_torch.core.ndmp import Simulator
from repro_torch.dist.sync import global_mixer, sync_bytes_per_client
from repro_torch.kernels.mix_accumulate import mix_accumulate
from repro_torch.kernels.ref import mix_accumulate_ref
from repro_torch.kernels.wire_codec import (dequant_accumulate, dequantize_block,
                                            gather_mix_int8, padded_width,
                                            quantize_block)
from repro_torch.launch.steps import dfl_local_step
from repro_torch.models.convert import tree_from_numpy
from repro_torch.obs.rounds import RoundLedger
from repro_torch.optim import optimizers as topt
from repro_torch.overlay.controller import OverlayController
from repro_torch.overlay.events import ChurnTrace
from repro_torch.runtime.loop import SlotTrainLoop
from repro_torch.wire.codec import (WIRE_CODECS, Int4BlockCodec, Int8BlockCodec,
                                    get_codec)

CODEC_NAMES = tuple(WIRE_CODECS)
BLOCK_CODECS = ("int8-block", "int4-block")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep each xdist worker's intra-op pool small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _rows(B, N, seed):
    """(B, N) f32 rows whose magnitudes differ from row to row."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N)) * rng.uniform(0.01, 10.0, (B, 1))).astype(np.float32)


def _special_rows(N, block, levels, seed):
    """Rows over N columns with, in row 0, an all-zero block and a block of
    exact .5 ties (max|x| = levels/2 gives the stored scale 0.5, and the
    entries are odd multiples of 0.25), random rows below."""
    x = _rows(3, N, seed)
    x[0, :block] = 0.0
    tie = np.arange(block, dtype=np.float32) % 7 * 0.5 + 0.25
    tie[0] = levels / 2.0
    x[0, block:2 * block] = tie * np.where(np.arange(block) % 2, -1, 1)
    return x


# --------------------------------------------------------------------------
# the kernels' plain paths against the Pallas kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,block", [(1, 128), (128, 128), (1000, 64), (257, 32)])
def test_padded_width_matches_jax(n, block):
    assert padded_width(n, block) == jwc.padded_width(n, block)


@pytest.mark.parametrize("levels", [127, 7])
@pytest.mark.parametrize("block", [128, 64, 32])
def test_quantize_and_dequantize_block_match_jax_bit_for_bit(levels, block):
    """q, the scales, the residual and the decode bit-equal to JAX on
    ragged N, an all-zero block and exact .5 ties.  The residual x − q·s
    is exact whether or not it is fused (q·s carries 8 + 8 significant
    bits), so the FMA question does not arise.  The port writes the
    residual over its input, in place, and decodes into an out of N
    columns with the first N of the reference's NB·block."""
    N = 1000
    x = _special_rows(N, block, levels, seed=block + levels)
    jq, js, jr = jwc.quantize_block(jnp.asarray(x), block=block, levels=levels,
                                    with_residual=True, interpret=True)
    xt = torch.from_numpy(x.copy())
    q_out = torch.empty((3, padded_width(N, block)), dtype=torch.int8)
    q, s, r = quantize_block(xt, block=block, levels=levels, with_residual=True,
                             q_out=q_out, residual_out=xt)
    assert q is q_out and r is xt
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(), _f32(js))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    assert not q[0, :block].any() and float(s[0, 0]) == 0.0
    # the tie block rounds half to even, as jnp.round does
    assert float(s[0, 1]) == 0.5
    np.testing.assert_array_equal(q[0, block:block + 4].numpy(), [round(v) for v in
                                  (x[0, block:block + 4] / 0.5)])
    jd = jwc.dequantize_block(jq, js, block=block, interpret=True)
    np.testing.assert_array_equal(dequantize_block(q, s, block=block).numpy(),
                                  np.asarray(jd))
    out = torch.empty((3, N))
    assert dequantize_block(q, s, block=block, out=out) is out
    np.testing.assert_array_equal(out.numpy(), np.asarray(jd)[:, :N])


def test_quantize_block_subnormal_scales_follow_ieee():
    """Blocks whose max / levels is subnormal in f32 (and so in bf16).
    Reading on the CPU: XLA flushes subnormal results to 0, so those
    scales are 0 there (then s_used = 1, q = 0 and the residual is x,
    itself 0 where x is subnormal), as is a subnormal residual of a
    block with a normal scale, where IEEE arithmetic keeps them.  The
    port follows IEEE, as the CUDA kernel does under -ftz=false; the
    kernel is held to this plain version on the card.  Every other block
    is bit-equal to JAX, and the port's subnormal blocks still decode
    within the codec's bound."""
    block, levels = 32, 127
    amax = [1.0, 2e-38, 1e-37, 1.4e-36, 1.6e-36, 1e-30]
    x = np.zeros((1, block * len(amax)), np.float32)
    for j, a in enumerate(amax):
        x[0, j * block:(j + 1) * block] = np.float32(a) * np.linspace(
            -1, 1, block, dtype=np.float32)
    jq, js, jr = map(np.asarray, jwc.quantize_block(
        jnp.asarray(x), block=block, levels=levels, with_residual=True,
        interpret=True))
    q, s, r = quantize_block(torch.from_numpy(x), block=block, levels=levels,
                             with_residual=True)
    subnormal = np.array([0 < a / levels < np.finfo(np.float32).tiny for a in
                          np.float32(amax)])
    assert subnormal.tolist() == [False, True, True, True, False, False]
    ts = s.float().numpy()[0]
    np.testing.assert_array_equal(ts[~subnormal], _f32(js)[0][~subnormal])
    assert (_f32(js)[0][subnormal] == 0).all() and (ts[subnormal] > 0).all()
    cols = np.repeat(~subnormal, block)
    np.testing.assert_array_equal(q.numpy()[0][cols], jq[0][cols])
    # the residual of a block with a normal but tiny scale is itself
    # subnormal, and XLA flushes it to 0 where the port keeps it
    tiny = np.finfo(np.float32).tiny
    tr = r.numpy()[0]
    np.testing.assert_array_equal(np.where(np.abs(tr) < tiny, 0.0, tr)[cols],
                                  jr[0][cols])
    assert (np.abs(tr[cols]) < tiny).any()
    np.testing.assert_array_equal(jr[0][~cols], np.where(np.abs(x[0]) < tiny, 0.0,
                                                         x[0])[~cols])
    dec = dequantize_block(q, s, block=block)
    assert ((dec - torch.from_numpy(x)).abs()
            <= Int8BlockCodec(block=block).tolerance(torch.from_numpy(x))).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["accumulate", "init"])
def test_mix_accumulate_matches_jax(dtype, form):
    """Both forms, bit-equal to JAX: XLA contracts the reference's
    acc + x·w into one fused multiply-add, and the plain version rounds
    the exact sum once to f32 as well.  The result lands in acc or in x,
    in place, with the same bits."""
    rng = np.random.default_rng(3)
    acc, x = _rows(5, 1500, 1), rng.normal(size=(5, 1500)).astype(np.float32)
    w = rng.random(5).astype(np.float32)
    jd = getattr(jnp, dtype)
    jacc = None if form == "init" else jnp.asarray(acc).astype(jd)
    jx = jnp.asarray(x).astype(jd)
    want = _f32(j_mix_accumulate(jacc, jx, jnp.asarray(w), interpret=True)
                .astype(jnp.float32))
    td = getattr(torch, dtype)
    tacc = None if form == "init" else torch.from_numpy(acc).to(td)
    tx = torch.from_numpy(x).to(td)
    got = mix_accumulate(tacc, tx, torch.from_numpy(w))
    np.testing.assert_array_equal(got.float().numpy(), want)
    target = tx.clone() if tacc is None else tacc.clone()
    inplace = mix_accumulate(None if tacc is None else target,
                             tx.clone() if tacc is not None else target,
                             torch.from_numpy(w), out=target)
    assert inplace is target and torch.equal(inplace, got)


@pytest.mark.parametrize("block", [128, 32])
@pytest.mark.parametrize("C", [2, 8, 33])
def test_gather_mix_int8_matches_jax(C, block):
    """Against JAX gather_mix_int8 (interpret mode) within 1e-6 x
    max|dequant| (f32 sums of C terms in another order); numpy and
    tensor sources; an out of N < NB·block columns gets the first N."""
    N = 1000
    x = _rows(C, N, C)
    q, s = quantize_block(torch.from_numpy(x), block=block)
    rng = np.random.default_rng(C)
    srcs = rng.integers(0, C, (C, 5))
    srcs[::2, 1] = srcs[::2, 0]
    w = rng.random((C, 5)).astype(np.float32)
    want = np.asarray(jwc.gather_mix_int8(
        jnp.asarray(q.numpy()), jnp.asarray(s.float().numpy()).astype(jnp.bfloat16),
        srcs, jnp.asarray(w), block=block, interpret=True))
    tol = 1e-6 * dequantize_block(q, s, block=block).abs().max().item()
    for src in (srcs, torch.from_numpy(srcs)):
        got = gather_mix_int8(q, s, src, torch.from_numpy(w), block=block)
        assert got.shape == (C, padded_width(N, block))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    out = torch.empty((C, N))
    assert gather_mix_int8(q, s, srcs, torch.from_numpy(w), block=block, out=out) is out
    np.testing.assert_array_equal(out.numpy(), got[:, :N].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [128, 64, 32])
def test_dequant_accumulate_matches_jax(block, dtype):
    """The fused receive fold against the Pallas kernel in interpret mode,
    bit for bit: the accumulate form into an acc of N columns, ragged
    (1000) or whole (1024) against the wire's NB·block, in acc's dtype and
    in place; the init form over the full wire width in f32.  XLA
    contracts the reference's acc + w·(q·s) into one fused multiply-add,
    and the plain version rounds the sum once as well."""
    rng = np.random.default_rng(block)
    x = _special_rows(1024, block, 127, seed=block)
    q, s = quantize_block(torch.from_numpy(x), block=block)
    w = rng.random(3).astype(np.float32)
    jq, js = jnp.asarray(q.numpy()), jnp.asarray(s.float().numpy()).astype(jnp.bfloat16)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    for N in (1000, 1024):
        acc = _rows(3, N, N).astype(np.float32)
        want = _f32(jwc.dequant_accumulate(jnp.asarray(acc).astype(jd), jq, js,
                                           jnp.asarray(w), block=block,
                                           interpret=True).astype(jnp.float32))
        tacc = torch.from_numpy(acc).to(td)
        got = dequant_accumulate(tacc, q, s, torch.from_numpy(w), block=block)
        assert got.dtype == td and got.shape == (3, N)
        np.testing.assert_array_equal(got.float().numpy(), want)
        target = tacc.clone()
        assert dequant_accumulate(target, q, s, torch.from_numpy(w), block=block,
                                  out=target) is target
        assert torch.equal(target, got)
    init = dequant_accumulate(None, q, s, torch.from_numpy(w), block=block)
    want = jwc.dequant_accumulate(None, jq, js, jnp.asarray(w), block=block,
                                  interpret=True)
    assert init.dtype == torch.float32 and init.shape == (3, 1024)
    np.testing.assert_array_equal(init.numpy(), np.asarray(want))


def test_dequant_accumulate_rounds_once_where_double_rounding_would_not():
    """acc = 2^31, w·(q·s) = 128·(1 + 193·2^-37): the exact sum lies just
    above the midpoint between 2^31 and its next f32 value.  Rounded
    first to float64 the sum would land on the midpoint and then round
    to even, 2^31; rounded once it is 2^31 + 256, as XLA's fused
    multiply-add, the CUDA fmaf, dequant_accumulate_ref and
    mix_accumulate_ref (on the decoded row, as the generic receive
    folds it) give."""
    w = np.float32(14190909 * 2.0 ** -23)
    s = np.full((1, 1), 149 * 2.0 ** -7, np.float32)
    q = np.zeros((1, 128), np.int8)
    q[0, 0] = 65
    acc = np.full((1, 128), 2.0 ** 31, np.float32)
    got = dequant_accumulate(torch.from_numpy(acc), torch.from_numpy(q),
                             torch.from_numpy(s).to(torch.bfloat16), torch.tensor([w]))
    want = jwc.dequant_accumulate(jnp.asarray(acc), jnp.asarray(q),
                                  jnp.asarray(s).astype(jnp.bfloat16), jnp.asarray([w]),
                                  interpret=True)
    assert float(got[0, 0]) == float(want[0, 0]) == 2.0 ** 31 + 256
    x = np.zeros((1, 128), np.float32)
    x[0, 0] = 65 * s[0, 0]
    once = mix_accumulate_ref(torch.from_numpy(acc), torch.from_numpy(x),
                              torch.tensor([w]))
    jonce = j_mix_accumulate(jnp.asarray(acc), jnp.asarray(x), jnp.asarray([w]),
                             interpret=True)
    assert float(once[0, 0]) == float(jonce[0, 0]) == 2.0 ** 31 + 256
    assert float(np.float32(np.float64(acc[0, 0]) + np.float64(x[0, 0]) * np.float64(w))) \
        == 2.0 ** 31


def test_kernel_wrappers_reject_bad_shapes():
    q, s = quantize_block(torch.ones((2, 100)), block=32)
    with pytest.raises(ValueError, match="do not agree"):
        dequantize_block(q, s, block=64)
    with pytest.raises(ValueError, match="q_out"):
        quantize_block(torch.ones((2, 100)), q_out=torch.empty((2, 100), dtype=torch.int8))
    with pytest.raises(ValueError, match="columns"):
        gather_mix_int8(q, s, np.zeros((2, 1), np.int64), torch.ones((2, 1)),
                        block=32, out=torch.empty((2, 200)))
    with pytest.raises(ValueError, match="columns"):
        dequantize_block(q, s, block=32, out=torch.empty((2, 200)))
    with pytest.raises(ValueError, match="w must be"):
        mix_accumulate(None, torch.ones((2, 3)), torch.ones(3))
    with pytest.raises(ValueError, match="exceeds wire width"):
        dequant_accumulate(torch.ones((2, 129)), q, s, torch.ones(2), block=32)
    with pytest.raises(ValueError, match="do not agree"):
        dequant_accumulate(None, q, s, torch.ones(2), block=64)
    with pytest.raises(ValueError, match="w must be"):
        dequant_accumulate(None, q, s, torch.ones(3), block=32)
    with pytest.raises(ValueError, match="out must be"):
        dequant_accumulate(torch.ones((2, 100)), q, s, torch.ones(2), block=32,
                           out=torch.empty((2, 100), dtype=torch.bfloat16))


# --------------------------------------------------------------------------
# the codecs against the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", CODEC_NAMES)
def test_codec_encode_decode_and_tolerance_match_jax(name):
    """decode ∘ encode within the codec's tolerance, the tolerance equal
    to the reference's (1e-6 relative: the same f32 formulas), and the
    decoded rows equal to the reference's: bit for bit for the exact,
    bf16 and block codecs; for topk on inputs without ties in |x|, whose
    kept set is then unique (the index order may differ)."""
    codec, jcodec = get_codec(name), j_get_codec(name)
    x = _rows(4, 700, 11)
    xt = torch.from_numpy(x)
    dec = codec.decode(codec.encode(xt), 700)
    tol = codec.tolerance(xt)
    assert ((dec - xt).abs() <= tol).all()
    np.testing.assert_allclose(tol.numpy(), np.asarray(jcodec.tolerance(jnp.asarray(x))),
                               rtol=1e-6, atol=0)
    want = np.asarray(jcodec.decode(jcodec.encode(jnp.asarray(x)), 700))
    np.testing.assert_array_equal(dec.numpy(), want)
    if codec.exact:
        np.testing.assert_array_equal(dec.numpy(), x)


@pytest.mark.parametrize("name", CODEC_NAMES)
def test_codec_wire_parts_match_jax(name):
    """The parts that would cross the wire carry the reference's bytes
    (bf16: the same 16 bits; int8: q and scales; int4: the packed
    nibbles; topk: the same (index, value) pairs), and wire_bytes is the
    actual bytes of the parts."""
    codec, jcodec = get_codec(name), j_get_codec(name)
    for N in (1, 127, 128, 700):
        x = _rows(3, N, N)
        wire = codec.encode(torch.from_numpy(x))
        jwire = jcodec.encode(jnp.asarray(x))
        assert sum(t.numel() * t.element_size() for t in wire) == 3 * codec.wire_bytes(N)
        assert len(wire) == len(jwire)
        if name == "topk":
            for b in range(3):
                pairs = dict(zip(wire[1][b].tolist(), wire[0][b].tolist()))
                jpairs = dict(zip(np.asarray(jwire[1][b]).tolist(),
                                  np.asarray(jwire[0][b]).tolist()))
                assert pairs == jpairs
            continue
        for part, jpart in zip(wire, jwire):
            jp = np.asarray(jpart)
            if part.dtype == torch.bfloat16:
                np.testing.assert_array_equal(part.float().numpy(), _f32(jp))
            else:
                np.testing.assert_array_equal(part.numpy().view(jp.dtype), jp)


@pytest.mark.parametrize("name", CODEC_NAMES)
def test_codec_bytes_match_jax_closed_forms(name):
    codec, jcodec = get_codec(name), j_get_codec(name)
    for N in (1, 63, 128, 129, 4096, 494674944):
        assert codec.wire_bytes(N) == jcodec.wire_bytes(N)
        assert codec.payload_bytes(N) == jcodec.payload_bytes(N)
    for strategy in ("fedlay", "ring", "complete", "allreduce", "none"):
        for n, K in [(8, None), (8, 5)]:
            kw = dict(num_spaces=2, active_clients=K, codec=name)
            assert sync_bytes_per_client(strategy, 4 * 4096, n, **kw) == \
                j_sync_bytes(strategy, 4 * 4096, n, **kw)


@pytest.mark.parametrize("name", ["int8-block", "int4-block", "topk"])
def test_encode_ef_residual_matches_jax(name):
    """The error-feedback residual equal to the reference's on identical
    input (bit for bit: the block codecs' residual is exact, topk zeroes
    the kept entries), written into the buffer given, which may be the
    input; the workspace buffers are the ones the wire is made of."""
    codec, jcodec = get_codec(name), j_get_codec(name)
    x = _rows(4, 900, 5)
    _, jres = jcodec.encode_ef(jnp.asarray(x))
    xt = torch.from_numpy(x.copy())
    ws = codec.workspace(4, 900, xt.device)
    wire, res = codec.encode_ef(xt, ws, residual_out=xt)
    assert res is xt
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    if ws:
        ptrs = {t.data_ptr() for t in ws.values()}
        assert all(t.data_ptr() in ptrs for t in wire)


def test_block_codecs_serve_other_blocks():
    """block is a field: 64 and 32 decode as the reference's do."""
    from repro.wire.codec import Int4BlockCodec as JInt4, Int8BlockCodec as JInt8
    x = _rows(2, 300, 2)
    for cls, jcls in ((Int8BlockCodec, JInt8), (Int4BlockCodec, JInt4)):
        for block in (64, 32):
            codec, jcodec = cls(block=block), jcls(block=block)
            np.testing.assert_array_equal(
                codec.decode(codec.encode(torch.from_numpy(x)), 300).numpy(),
                np.asarray(jcodec.decode(jcodec.encode(jnp.asarray(x)), 300)))
            assert codec.wire_bytes(300) == jcodec.wire_bytes(300)


def test_codec_registry_and_accumulate():
    """The registry resolves names, instances and None as the reference's
    does; the generic accumulate receive matches the reference's (bf16,
    one rounding of acc + w·x); int8-block's fused receive,
    dequant_accumulate, matches the reference's bit for bit and folds in
    place into acc through ``out``."""
    assert get_codec(None) is None and get_codec("int8-block") is WIRE_CODECS["int8-block"]
    assert get_codec(Int8BlockCodec(block=64)) == Int8BlockCodec(block=64)
    with pytest.raises(ValueError, match="codec"):
        get_codec("zstd")
    with pytest.raises(ValueError, match="rate"):
        get_codec("topk").__class__(rate=0.0)
    acc, x = _rows(3, 200, 1), _rows(3, 200, 2)
    w = np.array([0.25, 0.5, 0.125], np.float32)
    codec, jcodec = get_codec("bf16"), j_get_codec("bf16")
    got = codec.accumulate(torch.from_numpy(acc), codec.encode(torch.from_numpy(x)),
                           torch.from_numpy(w))
    want = jcodec.accumulate(jnp.asarray(acc), jcodec.encode(jnp.asarray(x)),
                             jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    codec, jcodec = get_codec("int8-block"), j_get_codec("int8-block")
    wire = codec.encode(torch.from_numpy(x))
    jwire = (jnp.asarray(wire[0].numpy()),
             jnp.asarray(wire[1].float().numpy()).astype(jnp.bfloat16))
    target = torch.from_numpy(acc.copy())
    got = codec.accumulate(target, wire, torch.from_numpy(w), out=target)
    want = jcodec.accumulate(jnp.asarray(acc), jwire, jnp.asarray(w))
    assert got is target
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# the codec round of global_mixer
# --------------------------------------------------------------------------

C_MIX, N_MIX = 8, 1000
VARIANTS = ("unmasked", "masked", "edge_mask")


def _mix_inputs(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(C_MIX, N_MIX)).astype(np.float32)
    R = (rng.normal(size=(C_MIX, N_MIX)) * 0.01).astype(np.float32)
    mask = (rng.random(C_MIX) > 0.3).astype(np.float32)
    mask[0], mask[1] = 0.0, 1.0
    em = (rng.random((C_MIX, 4)) > 0.25).astype(np.float32)
    return X, R, mask, em


@pytest.mark.parametrize("name", CODEC_NAMES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_codec_round_matches_jax(name, variant):
    """global_mixer(codec=…, flat_io=True) against the JAX round on the
    same buffer, residual and table: the output within 1e-6 x max|buf|
    (the port adds the self term by one fused multiply-add after the
    gather, the reference by a separate add); the residual bit-equal,
    masked-out rows keeping theirs; rows that do not mix are the input's
    bits."""
    X, R, mask, em = _mix_inputs(VARIANTS.index(variant))
    codec = get_codec(name)
    masked = variant != "unmasked"
    margs = (mask,) if masked else ()
    kw = {"edge_mask": em} if variant == "edge_mask" else {}
    sched = build_permute_schedule(C_MIX, 2)
    mixer = global_mixer("fedlay", sched, masked=masked, codec=name, flat_io=True)
    jmixer = j_global_mixer("fedlay", j_build(C_MIX, 2), masked=masked, codec=name,
                            flat_io=True)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jargs = tuple(jnp.asarray(a) for a in margs)
    buf, out = torch.from_numpy(X), torch.empty((C_MIX, N_MIX))
    ws = codec.workspace(C_MIX, N_MIX, buf.device)
    if codec.error_feedback:
        res = torch.from_numpy(R.copy())
        got, got_res = mixer(buf, *margs, res, out=out, workspace=ws, **kw)
        want, want_res = jmixer(jnp.asarray(X), *jargs, jnp.asarray(R), **jkw)
        assert got_res is res
        np.testing.assert_array_equal(res.numpy(), np.asarray(want_res))
        if masked:
            np.testing.assert_array_equal(res.numpy()[mask == 0], R[mask == 0])
    else:
        got = mixer(buf, *margs, out=out, workspace=ws, **kw)
        want = jmixer(jnp.asarray(X), *jargs, **jkw)
    assert got is out
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * np.abs(X).max())
    if masked:
        np.testing.assert_array_equal(got.numpy()[mask == 0], X[mask == 0])


@pytest.mark.parametrize("variant", VARIANTS)
def test_none_codec_round_bit_equals_codec_free_round(variant):
    """The exactness control arm: the none codec's round gives the
    codec-free flat round's bits."""
    X, _, mask, em = _mix_inputs(7)
    masked = variant != "unmasked"
    margs = (mask,) if masked else ()
    kw = {"edge_mask": em} if variant == "edge_mask" else {}
    sched = build_permute_schedule(C_MIX, 2)
    free = global_mixer("fedlay", sched, masked=masked, fuse="flat", flat_io=True)
    none = global_mixer("fedlay", sched, masked=masked, codec="none", flat_io=True)
    assert torch.equal(none(torch.from_numpy(X), *margs, **kw),
                       free(torch.from_numpy(X), *margs, **kw))


@pytest.mark.parametrize("name", ["int8-block", "bf16"])
def test_codec_tree_mixer_matches_jax(name):
    """The tree form (flat_io=False) ravels through FlatSpec as the
    reference's does; a lossy round refuses to write over its input."""
    rng = np.random.default_rng(9)
    tree = {"a": rng.normal(size=(C_MIX, 5, 7)).astype(np.float32),
            "b": rng.normal(size=(C_MIX, 33)).astype(np.float32)}
    mixer = global_mixer("ring", build_permute_schedule(C_MIX, 1), codec=name)
    jmixer = j_global_mixer("ring", j_build(C_MIX, 1), codec=name)
    targs = ({k: torch.from_numpy(v) for k, v in tree.items()},)
    jargs = ({k: jnp.asarray(v) for k, v in tree.items()},)
    if get_codec(name).error_feedback:
        from repro_torch.dist.flat import FlatSpec
        n = FlatSpec.for_tree(targs[0]).size
        targs += (torch.zeros((C_MIX, n)),)
        jargs += (jnp.zeros((C_MIX, n)),)
        got, want = mixer(*targs)[0], jmixer(*jargs)[0]
    else:
        got, want = mixer(*targs), jmixer(*jargs)
    for k, v in tree.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-6 * np.abs(v).max())
    flat = global_mixer("ring", build_permute_schedule(C_MIX, 1), codec="bf16",
                        flat_io=True)
    buf = torch.zeros((C_MIX, 64))
    with pytest.raises(ValueError, match="must not be buf"):
        flat(buf, out=buf)


# --------------------------------------------------------------------------
# SlotTrainLoop under a codec, against the JAX loop
# --------------------------------------------------------------------------

CAPACITY, SEQ, ROUNDS = 4, 16, 5
LM_J_CFG = j_tiny_lm(vocab=256, d_model=64, layers=1)
LM_CFG = t_tiny_lm(vocab=256, d_model=64, layers=1)
LM_CHURN = [(1.5, "fail", 1), (2.5, "join", 50, 0)]
_j_init = jax.jit(lambda key: j_init_params(LM_J_CFG, key, dtype=jnp.float32))


def _lm_params(node_id):
    return jax.tree.map(np.asarray, _j_init(jax.random.PRNGKey(node_id)))


def _lm_batch(node_ids, step):
    toks = np.stack([np.random.default_rng([u, step]).integers(
        0, LM_J_CFG.vocab_size, (1, SEQ + 1)) for u in node_ids]).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _sim(cls, n):
    sim = cls(num_spaces=2, latency=0.05, heartbeat_period=0.5,
              probe_period=1.0, seed=0)
    sim.seed_network(list(range(n)))
    return sim


def _ptrs(loop):
    """The resident buffers' storage: the two population buffers (which
    swap roles every round), the residual and the codec's wire."""
    return ({loop.params.data_ptr(), loop._spare.data_ptr()},
            [t.data_ptr() for t in (loop.residual, *loop.workspace.values())])


def _recording(controller_cls, calls):
    """``controller_cls`` with a mixer that records each round's buffer,
    residual before, mask and residual after, as numpy copies."""
    class Recording(controller_cls):
        @property
        def mixer(self):
            inner = super().mixer

            def run(buf, mask, residual, **kw):
                seen = (np.array(buf), np.array(residual), np.array(mask))
                out, res = inner(buf, mask, residual, **kw)
                calls.append(seen + (np.array(res),))
                return out, res
            return run
    return Recording


@pytest.fixture(scope="module", params=BLOCK_CODECS)
def codec_runs(request):
    """One JAX and one port run of ROUNDS rounds under a block codec:
    capacity 4, 3 live, a fail and a join, sgd(0.05), fedlay over 2
    spaces with resident flat parameters.  Both loops record each mixing
    round's inputs and residual (``_recording``); the port's loop also
    records, by round, the residual rows of the slots each plan resets,
    as the plan lands."""
    from repro.launch.mesh import make_local_mesh
    from repro.launch.steps import dfl_train_bundle
    from repro.models.config import INPUT_SHAPES
    import dataclasses
    name = request.param
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=CAPACITY,
                                seq_len=SEQ)
    bundle = dfl_train_bundle(LM_J_CFG, shape, make_local_mesh(1, 1), jopt.sgd(0.05),
                              dtype=jnp.float32, sync="none", masked=True)
    jledger, tledger = JRoundLedger(), RoundLedger()
    jcalls, tcalls = [], []
    jloop = JSlotTrainLoop(
        _recording(JController, jcalls)(_sim(JSimulator, 3), capacity=CAPACITY,
                                        fuse="flat", flat_io=True, codec=name),
        local_step=bundle.step, optimizer=jopt.sgd(0.05), ledger=jledger,
        make_params=lambda u: jax.tree.map(jnp.asarray, _lm_params(u)),
        make_batch=lambda ids, s: {k: jnp.asarray(v) for k, v in _lm_batch(ids, s).items()})
    resets = {}

    class Recording(SlotTrainLoop):
        def _apply_plan(self, plan):
            from repro_torch.runtime.slots import plan_reset_slots
            out = super()._apply_plan(plan)
            resets[len(tcalls)] = {s: self.residual[s].clone()
                                   for s in plan_reset_slots(plan)}
            return out

    tloop = Recording(
        _recording(OverlayController, tcalls)(_sim(Simulator, 3), capacity=CAPACITY,
                                              fuse="flat", flat_io=True, codec=name),
        local_step=dfl_local_step(LM_CFG, topt.sgd(0.05)), optimizer=topt.sgd(0.05),
        make_params=lambda u: tree_from_numpy(_lm_params(u)), ledger=tledger,
        make_batch=lambda ids, s: {k: torch.from_numpy(v)
                                   for k, v in _lm_batch(ids, s).items()})
    ptrs = _ptrs(tloop)
    trace_j, trace_t = JChurnTrace.scripted(LM_CHURN), ChurnTrace.scripted(LM_CHURN)
    jloop.run(ROUNDS, trace=trace_j)
    tloop.run(ROUNDS, trace=trace_t)
    return name, jloop, tloop, jledger, tledger, resets, ptrs, jcalls, tcalls


def _encoded(buf, residual, codec):
    """The block codec's encoding of one round's operand buf + residual by
    the plain version: (q, per-entry scales, residual) as numpy."""
    from repro_torch.kernels.ref import quantize_block_ref
    op = torch.from_numpy(buf) + torch.from_numpy(residual)
    q, s, r = quantize_block_ref(op, codec.block, codec.levels, True)
    N = buf.shape[1]
    return (q[:, :N].numpy(),
            s.float().repeat_interleave(codec.block, dim=1)[:, :N].numpy(), r.numpy())


def test_codec_slot_loop_matches_jax(codec_runs):
    """The same alive sequence and churn, each round's loss within 1e-5
    relative, and each round's encoding the same on both sides: the
    entries whose q or block scale differ between the two loops'
    operands (buf + residual) are at most 1 in 10^3 of the live entries.
    The operands differ in their last bits (the local steps sum in other
    orders), so the residuals are not bit-equal; a last-bit difference
    flips a q only for an entry that close to a rounding boundary, while
    a residual that is not carried, or carried in the wrong rows, moves
    the operand by up to half a step and flips about half the q.  The population within the codec's tolerance of
    the JAX loop's (a q flip moves a mixed entry by at most a step)."""
    name, jloop, tloop, *_, jcalls, tcalls = codec_runs
    jrec, trec = jloop.records, tloop.records
    assert [r.num_alive for r in trec] == [r.num_alive for r in jrec] == [3, 2, 3, 3, 3]
    assert [(r.joined, r.left) for r in trec] == [(r.joined, r.left) for r in jrec]
    for a, b in zip(trec, jrec):
        assert abs(a.loss - b.loss) <= 1e-5 * abs(b.loss)
    codec = get_codec(name)
    assert len(jcalls) == len(tcalls) == ROUNDS
    for (jb, jr, jm, _), (tb, tr, tm, _) in zip(jcalls, tcalls):
        np.testing.assert_array_equal(tm, jm)
        (jq, js, _), (tq, ts, _) = _encoded(jb, jr, codec), _encoded(tb, tr, codec)
        live = tm > 0
        differ = ((jq != tq) | (js != ts))[live]
        assert differ.sum() <= 1e-3 * differ.size
    jparams = torch.from_numpy(np.array(jloop.params))
    tol = codec.tolerance(jparams).numpy()
    np.testing.assert_array_less(np.abs(tloop.params.numpy() - jparams.numpy()),
                                 tol + 1e-6)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_codec_slot_loop_carries_residual_exactly(codec_runs, side):
    """Every round of each loop, bit for bit: a live row's residual
    afterwards is its operand's quantization residual, buf + residual
    minus its decode (the plain version, itself bit-equal to JAX); a
    masked row keeps its residual; and the residual a round starts from
    is the one the last round left, except the rows of the slots the
    round's plan reset, which are zero (the port's plans; the JAX loop
    lands the same plans)."""
    name, jloop, tloop, _, _, resets, _, jcalls, tcalls = codec_runs
    calls = tcalls if side == "port" else jcalls
    codec = get_codec(name)
    assert set(resets) == {1, 2}
    prev = None
    for t, (buf, rin, mask, rout) in enumerate(calls):
        live = (mask > 0)[:, None]
        want = np.where(live, _encoded(buf, rin, codec)[2], rin)
        np.testing.assert_array_equal(rout.view(np.int32), want.view(np.int32))
        if prev is not None:
            carried = prev.copy()
            carried[list(resets.get(t, ()))] = 0.0
            np.testing.assert_array_equal(rin.view(np.int32), carried.view(np.int32))
        prev = rout
    final = tloop.residual.numpy() if side == "port" else np.asarray(jloop.residual)
    np.testing.assert_array_equal(final, prev)


def test_codec_slot_loop_resets_and_keeps_residual_rows(codec_runs):
    """Joiner and leaver residual rows are zero as each plan lands; a slot
    that never held a client keeps a zero residual; every resident
    buffer (population, spare, residual, the codec's wire) keeps its
    storage."""
    name, jloop, tloop, _, _, resets, ptrs, _, _ = codec_runs
    assert resets and all(len(r) for r in resets.values())
    for rows in resets.values():
        for row in rows.values():
            assert not row.any()
    assert not tloop.residual[3].any()
    assert tloop.residual[0].any()
    assert _ptrs(tloop) == ptrs


def test_codec_slot_loop_ledger_matches_jax(codec_runs):
    """The round ledger's wire bytes (the codec's image) and payload bytes
    (the uncompressed row) equal the reference's."""
    _, _, _, jledger, tledger, *_ = codec_runs
    keys = ("wire_bytes_per_client", "payload_bytes_per_client")
    got = [tuple(r.extra[k] if k in r.extra else getattr(r, k) for k in keys)
           for r in tledger.rows]
    assert got == [tuple(getattr(r, k) for k in keys) for r in jledger.rows]
    assert all(w < p for w, p in got)
