#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and builds the
port's CUDA kernels from ``src/repro_torch/kernels/csrc/`` first.
Phases, each printing its lines:

1. environment: torch and CUDA versions, TF32 settings, the card;
2. build: every kernel of the port (``flash_decode``, ``gather_mix``),
   one ``nvcc`` per source, all started together, timed;
3. kernels: each kernel against its plain PyTorch version on the card:
   ``flash_decode`` at the CPU tests' shapes and at the ``decode_32k``
   width, with times; ``gather_mix`` over f32 and bf16, C from 2 to 200,
   ragged N, duplicate and tensor sources, and an output that is the
   input;
4. small: the ``tiny_lm`` ``ServeLoop`` on the card against the same on
   the CPU, token for token, and the ``tiny_lm`` ``SlotTrainLoop`` with a
   fail and a join on the card against the same on the CPU (alive
   sequence equal, losses within 1e-4 relative);
5. slice: ``run_slots`` serving Llama-3.2-3B at full width and depth
   (random f32 weights from a seeded generator), with the launch counts
   of the kernels, then one ``decode_step`` with the kernel against the
   same with the plain attention, a breakdown of one decode tick and one
   prefill (host time against device busy time), and the kernel at the
   slice's shape;
6. train: the DFL round, ``SlotTrainLoop`` over Llama-3.2-3B at full
   width with its depth cut to what fits (8 slots, 7 live, a fail and a
   join, sgd, fedlay mixing through ``gather_mix``), with its checks,
   per-round times, a profiled round, and the kernel at the round's
   shape against its plain version and ``torch.matmul``;
7. the ``kernels`` JSON line, the card's name and power limit, and the
   result line ``{"ok": true, "device": {...}}``.

Any failure raises, and the script exits non-zero without the result
line.  Without CUDA, or outside a checkout, it exits 1 at once.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SWEEP = [(1, 4, 1, 64, 256, 255), (2, 8, 2, 64, 700, 450),
         (2, 16, 2, 128, 1024, 100), (1, 8, 8, 64, 512, 511),
         (3, 8, 4, 32, 384, 0)]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def decode_tol(ref) -> dict:
    """The limit for flash_decode against its plain version, by the
    output's dtype.  f32: 1e-5.  bf16: both sides accumulate in f32 and
    round once to bf16, which can move an element by one bf16 step (at
    most 2^-7 of it), so rtol 1e-2, and for elements near 0 an atol of
    1e-2 x max |ref|.  The atol scales with the output because the output
    over n valid N(0, 1) rows is small (about sqrt(e / n)): a fixed atol
    would pass a lost span of the cache."""
    if ref.dtype.itemsize == 4:
        return dict(rtol=0.0, atol=1e-5)
    return dict(rtol=1e-2, atol=1e-2 * ref.float().abs().max().item())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, calls, reps: int) -> float:
    """Mean device time of one call, from two CUDA events around ``reps``
    passes over ``calls``, queued back to back behind a GPU sleep so that
    the host's enqueueing does not show.  Calls over inputs that together
    exceed the 50 MB L2 cache find it cold, as a decode tick does from
    one layer's cache to the next.  Keep the launches of reps * len(calls)
    calls under the depth of CUDA's launch queue (about a thousand)."""
    for call in calls:
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)          # ~0.1 s while the host queues
    start.record()
    for _ in range(reps):
        for call in calls:
            call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def host_ms(torch, fn, iters: int) -> float:
    """Mean wall time of one call of ``fn`` called back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def decode_bound(q, k, pos_list, L):
    """Least time for flash_decode on these inputs: each input read once,
    only the valid prefix of each cache row (``min(pos + 1, L)`` entries),
    the output written once; against 4 · valid · Hq · hd f32 operations."""
    B, Hq, hd = q.shape
    Hkv = k.shape[2]
    valid = sum(min(p + 1, L) for p in pos_list if p >= 0)
    nbytes = (2 * valid * Hkv * hd * k.element_size()
              + 2 * q.numel() * q.element_size() + 4 * B)
    ops = 4 * valid * Hq * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def measure_decode(torch, F, q, caches, pos, reps):
    """flash_decode against flash_decode_ref on the card over each (k, v)
    of ``caches``, held to :func:`decode_tol`: the worst error, the
    largest |ref|, the empty rows, and the kernel, plain, bound and
    library times of one call (``reps`` passes over the caches for the
    kernel, a tenth of that for the others)."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ref import flash_decode_ref
    B, L = q.shape[0], caches[0][0].shape[1]
    pos_list = pos.tolist()
    empty = [b for b in range(B) if pos_list[b] < 0]
    err = ref_max = 0.0
    for k, v in caches:
        out = flash_decode(q, k, v, pos)
        ref = flash_decode_ref(q, k, v, pos)
        torch.testing.assert_close(out.float(), ref.float(), **decode_tol(ref))
        err = max(err, (out.float() - ref.float()).abs().max().item())
        ref_max = max(ref_max, ref.float().abs().max().item())
        check(all(bool((out[b] == 0).all()) for b in empty),
              "an empty row of flash_decode is not exactly 0")
    # the library yardstick: one SDPA call with a boolean mask (the port
    # never calls it)
    idx = torch.arange(L, device=q.device)
    mask = (idx[None, :] <= pos[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :].to(caches[0][0].dtype)

    def call(fn, k, v):
        return lambda: fn(q, k, v, pos)

    def library(k, v):
        k4, v4 = k.transpose(1, 2), v.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=True)
    kernel_calls = [call(flash_decode, k, v) for k, v in caches]
    few = max(1, reps // 10)
    bound_ms, bound_by = decode_bound(q, caches[0][0], pos_list, L)
    return {"max_abs_err": err, "ref_max": ref_max, "empty_rows": len(empty),
            "ms": device_ms(torch, kernel_calls, reps),
            "host_ms": host_ms(torch, kernel_calls[0], 100),
            "plain_ms": device_ms(torch, [call(flash_decode_ref, k, v)
                                          for k, v in caches], few),
            "library_ms": device_ms(torch, [library(k, v) for k, v in caches], few),
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_kernels(torch, F, card):
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ref import flash_decode_ref
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        worst[name] = 0.0
        cases = [(B, Hq, Hkv, hd, L, torch.tensor([p] * B)) for
                 B, Hq, Hkv, hd, L, p in SWEEP]
        cases += [(5, 8, 2, 32, L, torch.tensor([0, L // 2, L - 1, -1, L + 3]))
                  for L in (64, 130, 160, 512, 700)]
        for B, Hq, Hkv, hd, L, pos in cases:
            q = randn(B, Hq, hd, dtype=dtype)
            k, v = randn(B, L, Hkv, hd, dtype=dtype), randn(B, L, Hkv, hd, dtype=dtype)
            pos = pos.to(device="cuda", dtype=torch.int32)
            out, ref = flash_decode(q, k, v, pos), flash_decode_ref(q, k, v, pos)
            torch.testing.assert_close(out.float(), ref.float(), **decode_tol(ref))
            for b in (pos < 0).nonzero().flatten().tolist():
                check(bool((out[b] == 0).all()), "empty row not exactly 0")
            worst[name] = max(worst[name], (out.float() - ref.float()).abs().max().item())
    print(f"kernels: flash_decode on the test cases: max abs err f32 "
          f"{worst['float32']:.3e} (tol 1e-5), bf16 {worst['bfloat16']:.3e} "
          f"(tol 1e-2 x max|ref| + 1e-2 |ref|); empty rows exactly 0")

    # the decode_32k width: B=16, Hq=24, Hkv=8, hd=128, L=32768, bf16
    B, Hq, Hkv, hd, L = 16, 24, 8, 128, 32768
    q = randn(B, Hq, hd, dtype=torch.bfloat16)
    k = randn(B, L, Hkv, hd, dtype=torch.bfloat16)
    v = randn(B, L, Hkv, hd, dtype=torch.bfloat16)
    pos = torch.randint(0, L, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos[3], pos[11], pos[0] = -1, -1, L - 1
    m = measure_decode(torch, F, q, [(k, v)], pos, 20)
    print(f"kernels: flash_decode bf16 (16, 24, 128) x (16, 32768, 8, 128), "
          f"{m['empty_rows']} empty rows: max abs err {m['max_abs_err']:.3e} "
          f"(tol {1e-2 * m['ref_max']:.3e} = 1e-2 x max|ref| + 1e-2 |ref|); "
          f"device time per call: kernel {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, "
          f"bound {m['bound_ms']:.4f} ms ({m['bound_by']}), "
          f"SDPA {m['library_ms']:.4f} ms; wall per kernel call "
          f"{m['host_ms']:.4f} ms ({card})")


def phase_small(torch):
    from repro_torch.configs import tiny_lm
    from repro_torch.models.model import LanguageModel
    from repro_torch.runtime.serving import ServeLoop
    import numpy as np
    cfg = tiny_lm()
    cpu = LanguageModel(cfg, torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(1, 17))),
             int(rng.integers(2, 13))) for _ in range(10)]
    done = []
    for model in (cpu, gpu):
        loop = ServeLoop(model, capacity=4, cache_len=28, prompt_len=16)
        for prompt, max_new in reqs:
            loop.submit(prompt, max_new=max_new)
        done.append({r.rid: r.tokens for r in loop.run()})
    check(done[0] == done[1], "tiny_lm tokens differ between card and CPU")
    print(f"small: tiny_lm ServeLoop, {len(reqs)} requests, "
          f"{sum(map(len, done[1].values()))} tokens: card == CPU token for token")


def profiled(torch, fn, repeats: int = 3):
    """Host time of ``fn`` (mean of ``repeats`` synchronised calls), and
    one profiled call's device time per kernel name, in ms."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / repeats
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us / 1e3
    return wall_ms, by_kernel


def tick_breakdown(torch, model, loop, card):
    """Where one decode tick and one 512-token prefill spend their time:
    host time against the device's busy time from the profiler."""
    from repro_torch.models.model import decode_step, init_cache, prefill

    # each call advances the copy's positions by one; 5 calls stay in range
    cache = {name: t.clone() for name, t in loop.cache.items()}
    tok = loop._tok.clone()
    wall, kernels = profiled(torch, lambda: decode_step(model, cache, tok))
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"breakdown: decode tick at batch 8: host {wall:.2f} ms, device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f} %), idle share "
          f"{100 * (1 - busy / wall):.1f} % ({card})")
    print("breakdown: tick kernels (ms): " + "; ".join(
        f"{name[:60]} {ms:.3f}" for name, ms in top))
    cache = init_cache(model, 1, 576, per_slot_pos=True)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, 512), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(4))
    lengths = torch.full((1,), 512, dtype=torch.int32, device="cuda")
    wall, kernels = profiled(torch, lambda: prefill(model, cache, prompt, lengths))
    busy = sum(kernels.values())
    print(f"breakdown: prefill of 512 tokens: host {wall:.2f} ms, device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f} %) ({card})")


def phase_slice(torch, F, card):
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import flash_decode as fd_mod
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gather_mix import gather_mix
    from repro_torch.kernels.ref import flash_decode_ref
    from repro_torch.launch.serve import run_slots
    from repro_torch.models import attention
    from repro_torch.models.model import LanguageModel, decode_step

    cfg = REGISTRY["llama3.2-3b"]
    t0 = time.perf_counter()
    model = LanguageModel(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"slice: {cfg.name} {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
          f"{n_params / 1e9:.3f} B f32 parameters, drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    args = argparse.Namespace(capacity=8, prompt_len=512, gen=64, requests=16,
                              policy="continuous")
    # warm-up: cuBLAS handles and workspaces, the allocator's pool
    run_slots(cfg, model, argparse.Namespace(**{**vars(args), "requests": 2,
                                                "gen": 4}),
              np.random.default_rng(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_decode.launches = gather_mix.launches = 0
    res = run_slots(cfg, model, args, np.random.default_rng(0))
    launches, mixes = flash_decode.launches, gather_mix.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = res["counters"].get("serve.decode_steps", 0)
    check(res["requests"] == args.requests, "not every request completed")
    check(launches > 0 and launches == cfg.num_layers * steps,
          f"flash_decode launches {launches} != {cfg.num_layers} x "
          f"{steps} decode steps")
    check(mixes == 0, f"serving launched gather_mix {mixes} times")
    print(f"slice: {res['requests']} requests, {res['tokens']} tokens in "
          f"{res['wall_s']:.3f} s: {res['tok_s']:.1f} tok/s, p50 "
          f"{res['p50_ms']:.1f} ms, p99 {res['p99_ms']:.1f} ms, peak memory "
          f"{peak_gb:.2f} GB; flash_decode launches {launches} = "
          f"{cfg.num_layers} layers x {steps} decode steps ({card})")

    # a live batch: six requests mid-generation, two empty slots
    loop = res["loop"]
    rng = np.random.default_rng(2)
    for _ in range(6):
        loop.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513))),
                    max_new=64)
    for _ in range(3):
        loop.tick()
    pos = loop.cache["pos"].clone()
    check(sorted(pos.tolist())[:2] == [-1, -1] and (pos >= 0).sum() == 6,
          f"unexpected live batch {pos.tolist()}")

    def step():
        cache = {name: t.clone() for name, t in loop.cache.items()}
        return decode_step(model, cache, loop._tok.clone())[0]
    with torch.no_grad():
        kernel_logits = step()
        attention.flash_decode = flash_decode_ref      # the plain attention
        try:
            plain_logits = step()
        finally:
            attention.flash_decode = fd_mod.flash_decode
    err = (kernel_logits - plain_logits).abs().max().item()
    scale = plain_logits.abs().max().item()
    check(bool(torch.isfinite(kernel_logits).all()), "non-finite logits")
    check(err <= 1e-3 * scale, f"decode_step logits differ by {err}")
    print(f"slice: decode_step on the live cache (pos {pos.tolist()}), kernel "
          f"vs plain attention: max abs logit err {err:.3e} <= 1e-3 x "
          f"{scale:.3f}")

    tick_breakdown(torch, model, loop, card)

    # the kernel at the slice's own shape and data: every layer's cache in
    # turn, as a decode tick reads them
    q = torch.randn((args.capacity, cfg.num_heads, cfg.resolved_head_dim),
                    generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda")
    caches = [(loop.cache["k"][i], loop.cache["v"][i])
              for i in range(cfg.num_layers)]
    m = measure_decode(torch, F, q, caches, loop.cache["pos"], 10)
    print(f"slice: flash_decode f32 at the slice's shape (8, 24, 128) x "
          f"(8, 576, 8, 128), the {cfg.num_layers} layers' caches in turn: "
          f"max abs err {m['max_abs_err']:.3e} (tol 1e-5); device time per call: kernel "
          f"{m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, bound "
          f"{m['bound_ms']:.4f} ms ({m['bound_by']}), SDPA "
          f"{m['library_ms']:.4f} ms; wall per kernel call "
          f"{m['host_ms']:.4f} ms ({card})")
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:98",
            "launches": launches, "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"]}


# --------------------------------------------------------------------------
# The DFL training round
# --------------------------------------------------------------------------

TRAIN_CAPACITY, TRAIN_LIVE, TRAIN_SEQ, TRAIN_ROUNDS = 8, 7, 1024, 6
TRAIN_CHURN = [(1.5, "fail", 3), (3.5, "join", 70, 0)]
CHUNK = 1 << 24            # columns per chunk when the plain version runs


def mix_tol(buf) -> dict:
    """The limit for gather_mix against its plain version.  f32: 1e-6 x
    max|buf| (rows of weights that sum to 1, a few f32 roundings of
    terms no larger than max|buf|).  bf16: both round the same f32 sum
    once, which can move an element by one bf16 step (2^-7 of it), plus
    the f32 part for elements near 0."""
    scale = buf.float().abs().max().item()
    if buf.dtype.itemsize == 4:
        return dict(rtol=0.0, atol=1e-6 * scale)
    return dict(rtol=2 ** -7, atol=1e-6 * scale)


def mix_table(torch, gen, C, K1):
    """A (C, K1) table: column 0 self, the rest random sources with a
    duplicate in every other row; row weights summing to 1."""
    srcs = torch.randint(0, C, (C, K1), generator=gen, device="cuda")
    srcs[:, 0] = torch.arange(C, device="cuda")
    srcs[::2, 2 % K1] = srcs[::2, 1 % K1]
    w = torch.rand((C, K1), generator=gen, device="cuda")
    return srcs, w / w.sum(dim=1, keepdim=True)


def check_gather_mix(torch):
    """gather_mix against gather_mix_ref on the card, held to mix_tol:
    f32 and bf16, C from 2 to 200 (registers up to 32, a shared-memory
    tile above), ragged N, numpy and tensor sources, an output that is
    the input."""
    from repro_torch.kernels.gather_mix import gather_mix
    from repro_torch.kernels.ref import gather_mix_ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        worst[name] = 0.0
        for C, N in [(2, 1), (3, 130), (8, 4096), (8, 1001), (16, 2050),
                     (32, 777), (33, 4096), (64, 3001), (200, 1000)]:
            buf = torch.randn((C, N), generator=gen, device="cuda").to(dtype)
            srcs, w = mix_table(torch, gen, C, 5)
            ref = gather_mix_ref(buf, srcs, w)
            for s in (srcs, srcs.cpu().numpy()):
                out = gather_mix(buf, s, w)
                torch.testing.assert_close(out.float(), ref.float(), **mix_tol(buf))
                worst[name] = max(worst[name], (out.float() - ref.float()).abs().max().item())
            inplace = buf.clone()
            check(gather_mix(inplace, srcs, w, out=inplace) is inplace,
                  "gather_mix did not return its out buffer")
            check(torch.equal(inplace, out), "gather_mix in place differs")
    torch.cuda.synchronize()
    print(f"kernels: gather_mix on C in 2..200, ragged N, numpy and tensor "
          f"sources, in place: max abs err f32 {worst['float32']:.3e} (tol 1e-6 x "
          f"max|buf|), bf16 {worst['bfloat16']:.3e} (tol 2^-7 |ref| + 1e-6 "
          f"max|buf|); in place == out of place bit for bit")


def slot_loop(torch, cfg, capacity, live, seq, device, seed, draw_on=None,
              mixer_factory=None, timed_step=None, loop_cls=None):
    """A SlotTrainLoop over ``cfg`` on ``device``: ``live`` clients of
    ``capacity`` slots, sgd(0.05), fedlay over 2 spaces with resident flat
    parameters; parameters from generators on ``draw_on`` (default
    ``device``) seeded by node, one sequence of ``seq`` tokens a client
    and round from numpy keyed by (node, round)."""
    import numpy as np
    from repro_torch.core.ndmp import Simulator
    from repro_torch.dist.flat import tree_map
    from repro_torch.launch.steps import dfl_local_step
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import sgd
    from repro_torch.overlay.controller import OverlayController
    from repro_torch.runtime.loop import SlotTrainLoop

    def make_params(node):
        gen = torch.Generator(device=draw_on or device).manual_seed(seed + node)
        return tree_map(lambda l: l.to(device), init_params(cfg, gen))

    def make_batch(ids, step):
        toks = np.stack([np.random.default_rng([u, step]).integers(
            0, cfg.vocab_size, (1, seq + 1)) for u in ids])
        t = torch.from_numpy(toks).to(device)
        return {"tokens": t[..., :-1], "labels": t[..., 1:]}

    sim = Simulator(num_spaces=2, latency=0.05, heartbeat_period=0.5,
                    probe_period=1.0, seed=0)
    sim.seed_network(list(range(live)))
    ctl = OverlayController(sim, capacity=capacity, fuse="flat", flat_io=True,
                            mixer_factory=mixer_factory)
    step = dfl_local_step(cfg, sgd(0.05))
    return (loop_cls or SlotTrainLoop)(
        ctl, local_step=timed_step(step) if timed_step else step,
        make_params=make_params, optimizer=sgd(0.05), make_batch=make_batch)


def small_train(torch):
    """tiny_lm under SlotTrainLoop on the card and on the CPU, the same
    parameters, data and churn: the same alive sequence, and each
    round's loss within 1e-4 relative (f32 on both; the card sums in
    other orders, over 6 rounds)."""
    from repro_torch.configs import tiny_lm
    from repro_torch.overlay.events import ChurnTrace
    runs = []
    for device in ("cpu", "cuda"):
        loop = slot_loop(torch, tiny_lm(), 8, 7, 64, device, seed=0, draw_on="cpu")
        recs = loop.run(6, trace=ChurnTrace.scripted(TRAIN_CHURN))
        runs.append(([r.num_alive for r in recs], [r.loss for r in recs]))
    (cpu_alive, cpu_loss), (gpu_alive, gpu_loss) = runs
    check(cpu_alive == gpu_alive, f"alive sequences differ: {cpu_alive} vs {gpu_alive}")
    err = max(abs(a - b) / abs(b) for a, b in zip(gpu_loss, cpu_loss))
    check(err <= 1e-4, f"tiny_lm losses differ by {err:.3e} relative")
    print(f"small: tiny_lm SlotTrainLoop, 8 slots, 6 rounds with a fail and a "
          f"join: card == CPU alive sequence {gpu_alive}, max loss difference "
          f"{err:.3e} relative (tol 1e-4)")


def flat_size(torch, cfg) -> int:
    """N, the flat row's width for ``cfg``, from shapes alone."""
    from repro_torch.dist.flat import FlatSpec, tree_map
    from repro_torch.models.model import init_params
    tree = init_params(cfg, torch.Generator(), device="meta")
    return FlatSpec.for_tree(tree_map(lambda l: l[None], tree)).size


def act_bytes(cfg, seq: int) -> int:
    """One client's activations in a forward and backward pass, reckoned:
    the f32 logits and three copies of their size (the softmax, its
    gradient, the unembedding's input gradient); per layer the attention
    scores and probabilities with their gradients (4 x Hq x S^2 f32) and
    sixteen (S, d_ff) f32 intermediates of the MLP and its gradient."""
    per_layer = 4 * cfg.num_heads * seq * seq * 4 + 16 * seq * cfg.d_ff * 4
    return 4 * seq * cfg.padded_vocab * 4 + cfg.num_layers * per_layer


def train_depth(torch, base):
    """The most layers whose reckoned bytes, (population + mixer output)
    x C x N x 4 + one gradient row + activations, stay within 80 % of
    the card's memory."""
    limit = 0.8 * torch.cuda.get_device_properties(0).total_memory
    best = None
    for layers in range(1, base.num_layers + 1):
        cfg = dataclasses.replace(base, num_layers=layers)
        N = flat_size(torch, cfg)
        resident = (2 * TRAIN_CAPACITY + 1) * N * 4
        total = resident + act_bytes(cfg, TRAIN_SEQ)
        if total > limit:
            break
        best = (cfg, N, resident, total)
    check(best is not None, "not even one layer fits the card")
    return best + (limit,)


def phase_train(torch, card):
    """The DFL round at Llama-3.2-3B width, with its checks and times."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import REGISTRY
    from repro_torch.dist import sync
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gather_mix import gather_mix
    from repro_torch.kernels.ref import gather_mix_ref, round_matrix
    from repro_torch.overlay.events import ChurnTrace
    from repro_torch.overlay.runtime import joiner_donors
    from repro_torch.runtime.loop import SlotTrainLoop

    base = REGISTRY["llama3.2-3b"]
    cfg, N, resident, reckoned, limit = train_depth(torch, base)
    C = TRAIN_CAPACITY
    print(f"train: {base.name} at full width (d_model {cfg.d_model}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied) cut to "
          f"{cfg.num_layers} of {base.num_layers} layers: the most whose "
          f"reckoned bytes, {resident / 1e9:.2f} GB resident ((2 x {C} + 1) x N "
          f"x 4, N = {N}) + {(reckoned - resident) / 1e9:.2f} GB activations, "
          f"stay within 80 % of the card's {limit / 0.8 / 1e9:.2f} GB; {C} slots, "
          f"{TRAIN_LIVE} live, 1 x {TRAIN_SEQ} tokens a client, sgd lr 0.05")

    times = {"local": [], "mix": []}

    def timed(fn, key):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    joins = []

    class CheckedLoop(SlotTrainLoop):
        """Holds each joiner's row to its donor's as the plan lands."""

        def _apply_plan(self, plan):
            joined, left = super()._apply_plan(plan)
            ctl = self.controller
            donors = joiner_donors(ctl.alive_schedule, ctl.alive, joined,
                                   tuple(u for u, _ in plan.survivors))
            for u in joined:
                check(donors[u] is not None, f"joiner {u} has no donor")
                a, b = ctl.slots.slot_of[u], ctl.slots.slot_of[donors[u]]
                check(torch.equal(self.params[a], self.params[b]),
                      f"joiner {u}'s row differs from donor {donors[u]}'s")
                joins.append((u, a, donors[u], b))
            return joined, left

    # record the round's table as it reaches the kernel
    last = {}
    real_gather_mix = sync.gather_mix

    def recording(buf, srcs, weights, out=None):
        last.update(srcs=srcs, weights=weights)
        return real_gather_mix(buf, srcs, weights, out=out)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop = slot_loop(
        torch, cfg, C, TRAIN_LIVE, TRAIN_SEQ, "cuda", seed=1000,
        mixer_factory=lambda sched: timed(sync.global_mixer(
            "fedlay", sched, masked=True, fuse="flat", flat_io=True), "mix"),
        timed_step=lambda step: timed(step, "local"), loop_cls=CheckedLoop)
    torch.cuda.synchronize()
    print(f"train: population ({C}, {N}) f32, {TRAIN_LIVE} clients drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    buffers = {loop.params.data_ptr(), loop._spare.data_ptr()}
    trace = ChurnTrace.scripted(TRAIN_CHURN)
    ctl = loop.controller
    dead_checked = 0
    sync.gather_mix = recording
    try:
        flash_decode.launches = gather_mix.launches = 0
        for r in range(TRAIN_ROUNDS):
            before = {s: loop.params[s].cpu() for s in range(C)
                      if ctl.slots.node_at(s) is None
                      or ctl.slots.node_at(s) in {e[2] for e in TRAIN_CHURN}}
            rec = loop.run(1, trace=trace)[-1]
            for s, row in before.items():
                if ctl.slots.node_at(s) is None:
                    check(torch.equal(loop.params[s].cpu(), row),
                          f"dead slot {s} changed in round {r}")
                    dead_checked += 1
            print(f"train: round {r}: {rec.num_alive} alive (joined "
                  f"{list(rec.joined)}, left {list(rec.left)}), loss {rec.loss:.6f}; "
                  f"local step {times['local'][-1]:.1f} ms, mixing "
                  f"{times['mix'][-1]:.2f} ms")
            check(np.isfinite(rec.loss), f"round {r} loss is not finite")
        launches, decodes = gather_mix.launches, flash_decode.launches
    finally:
        sync.gather_mix = real_gather_mix
    peak = torch.cuda.max_memory_allocated()
    check(launches == TRAIN_ROUNDS, f"gather_mix launches {launches} != "
          f"{TRAIN_ROUNDS} rounds")
    check(decodes == 0, f"training launched flash_decode {decodes} times")
    check([r.num_alive for r in loop.records] == [7, 6, 6, 7, 7, 7],
          f"alive sequence {[r.num_alive for r in loop.records]}")
    check(len(joins) == 1 and dead_checked > 0, "no join or no dead row checked")
    check({loop.params.data_ptr(), loop._spare.data_ptr()} == buffers,
          "a resident buffer was reallocated")
    print(f"train: gather_mix launches {launches} = {TRAIN_ROUNDS} rounds; dead "
          f"rows unchanged bit for bit ({dead_checked} row-rounds); joiner "
          f"{joins[0][0]} (slot {joins[0][1]}) == donor {joins[0][2]} (slot "
          f"{joins[0][3]}) bit for bit as the plan landed; 2 resident buffers "
          f"(the sgd state is empty), data_ptr unchanged over {TRAIN_ROUNDS} "
          f"rounds; peak memory {peak / 1e9:.2f} GB against {reckoned / 1e9:.2f} "
          f"GB reckoned ({card})")

    # the last round's output against the plain version, chunk by chunk
    # (its (C, K1, N) gather does not fit at full N)
    out, inp = loop.params, loop._spare
    srcs, weights = last["srcs"], last["weights"]
    err = scale = 0.0
    for a in range(0, N, CHUNK):
        ref = gather_mix_ref(inp[:, a:a + CHUNK], srcs, weights)
        err = max(err, (out[:, a:a + CHUNK] - ref).abs().max().item())
        scale = max(scale, inp[:, a:a + CHUNK].abs().max().item())
    check(err <= 1e-6 * scale, f"mixing output differs from the plain version by {err}")
    print(f"train: round {TRAIN_ROUNDS - 1}'s mixing output vs gather_mix_ref, "
          f"column chunk by chunk: max abs err {err:.3e} <= 1e-6 x max|buf| "
          f"{scale:.3f}")

    # one more round under the profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.run(1, trace=trace)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us / 1e3
    busy = sum(by_kernel.values())
    steady = range(3, TRAIN_ROUNDS)
    local = sum(times["local"][i] for i in steady) / len(steady)
    mix = sum(times["mix"][i] for i in steady) / len(steady)
    print(f"breakdown: DFL round at {cfg.num_layers} layers, {TRAIN_LIVE} live "
          f"clients: host {wall:.1f} ms for the profiled round; over rounds "
          f"3-{TRAIN_ROUNDS - 1} local step {local:.1f} ms and mixing {mix:.2f} ms "
          f"a round; device busy {busy:.1f} ms in the profiled round "
          f"({100 * busy / wall:.1f} %), idle share {100 * (1 - busy / wall):.1f} % "
          f"({card})")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    print("breakdown: round kernels (ms): " + "; ".join(
        f"{name[:60]} {ms:.3f}" for name, ms in top))

    # the kernel at the round's own shape and data
    W = round_matrix(C, srcs, weights)
    ms = device_ms(torch, [lambda: real_gather_mix(inp, srcs, weights, out=out)], 5)

    def plain():
        for a in range(0, N, CHUNK):
            gather_mix_ref(inp[:, a:a + CHUNK], srcs, weights)
    plain_ms = device_ms(torch, [plain], 1)
    library_ms = device_ms(torch, [lambda: torch.matmul(W, inp, out=out)], 3)
    t_bytes = 2 * C * N * 4 / HBM_BYTES_PER_S
    t_ops = 2 * C * C * N / F32_FLOPS_PER_S
    bound_ms, bound_by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                                     else "operations")
    print(f"train: gather_mix f32 at the round's shape C = {C}, K1 = "
          f"{srcs.shape[1]}, N = {N}: device time per call: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms (over column chunks of {CHUNK}), bound "
          f"{bound_ms:.3f} ms ({bound_by}), torch.matmul(W, buf) {library_ms:.3f} ms "
          f"({card})")
    return {"name": "gather_mix", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gather_mix.cu",
            "replaces": "src/repro/kernels/weighted_mix.py:230",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs one NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from repro_torch import resolve_device
    from repro_torch.kernels.build import SOURCES, build

    resolve_device("cuda")          # TF32 off for f32 products
    card = card_line()
    print(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"allow_tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}; card {card}")
    t0 = time.perf_counter()
    logs = build(SOURCES, verbose=True)
    print(f"build: {', '.join(f'{n}.cu' for n in SOURCES)} for sm_90a, "
          f"in parallel, in {time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}:", line.strip())

    phase_kernels(torch, F, card)
    check_gather_mix(torch)
    phase_small(torch)
    small_train(torch)
    serve_entry = phase_slice(torch, F, card)
    gc.collect()
    torch.cuda.empty_cache()
    train_entry = phase_train(torch, card)
    print(json.dumps({"kernels": [serve_entry, train_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
