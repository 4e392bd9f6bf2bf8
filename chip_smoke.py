#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and builds the
port's CUDA kernels from ``src/repro_torch/kernels/csrc/`` first.
Phases, each printing its lines:

1. environment: torch and CUDA versions, TF32 settings, the card;
2. build: every kernel of the serving path, with ``nvcc``, timed;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the CPU tests' shapes and at the ``decode_32k`` width, with times;
4. small: the ``tiny_lm`` ``ServeLoop`` on the card against the same on
   the CPU, token for token;
5. slice: ``run_slots`` serving Llama-3.2-3B at full width and depth
   (random f32 weights from a seeded generator), with the launch counts
   of the kernels, then one ``decode_step`` with the kernel against the
   same with the plain attention, a breakdown of one decode tick and one
   prefill (host time against device busy time), and the kernel at the
   slice's shape;
6. the ``kernels`` JSON line, the card's name and power limit, and the
   result line ``{"ok": true, "device": {...}}``.

Any failure raises, and the script exits non-zero without the result
line.  Without CUDA, or outside a checkout, it exits 1 at once.
"""

from __future__ import annotations

import argparse
import copy
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
    flash_decode.launches = 0
    res = run_slots(cfg, model, args, np.random.default_rng(0))
    launches = flash_decode.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = res["counters"].get("serve.decode_steps", 0)
    check(res["requests"] == args.requests, "not every request completed")
    check(launches > 0 and launches == cfg.num_layers * steps,
          f"flash_decode launches {launches} != {cfg.num_layers} x "
          f"{steps} decode steps")
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
    from repro_torch.kernels.build import build

    resolve_device("cuda")          # TF32 off for f32 products
    card = card_line()
    print(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"allow_tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}; card {card}")
    t0 = time.perf_counter()
    logs = build(["flash_decode"], verbose=True)
    print(f"build: flash_decode.cu for sm_90a in {time.perf_counter() - t0:.1f} s")
    for line in logs["flash_decode"].splitlines():
        if "registers" in line or "spill" in line:
            print("build:", line.strip())

    phase_kernels(torch, F, card)
    phase_small(torch)
    entry = phase_slice(torch, F, card)
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
