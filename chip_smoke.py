#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and builds the
port's CUDA kernels from ``src/repro_torch/kernels/csrc/`` first.
Phases, each printing its lines:

1. environment: torch and CUDA versions, TF32 settings, the card;
2. build: every kernel of the port, nine sources (``flash_decode``,
   ``gather_mix``, ``mix_accumulate``, ``quantize_block``,
   ``dequantize_block``, ``dequant_accumulate``, ``gather_mix_int8``,
   ``ssd_scan``, ``weighted_mix``), one ``nvcc`` per source, all started
   together, timed, with each ``flash_decode_kernel`` instantiation's
   registers and spill bytes from ptxas (the main path's marked) and a
   summary of ``weighted_mix_kernel``'s (its main path's without spills,
   checked); then the
   one-rank NCCL client group (``repro_torch.launch.mesh``) on a free
   localhost port;
3. kernels: each kernel against its plain PyTorch version on the card:
   ``flash_decode`` at the CPU tests' shapes and at the ``decode_32k``
   width, with times (each launch's device time from the profiler, one
   launch a call checked, the share of the bound, the wrapper's wall time
   a call) and two calls held bit for bit; ``gather_mix`` over f32 and
   bf16, C from 2 to its limit (1,816; the register body up to 24, the
   gather body above, the cohort round's 128 x 50,890), ragged N,
   duplicate and tensor sources, and an output that is the input, with
   the body each shape took, C one above the limit refused, and both
   bodies timed at C 16, 24, 28, 32 and 64 over N 50,890, 2^20 and 2^23 (the
   register body's threshold; each call one launch), and each body's
   ptxas registers and spills in ``build:`` lines (the gather body's
   within what two blocks of 512 an SM allow);
   ``quantize_block`` and ``dequantize_block`` bit for bit
   (levels 127 and 7, blocks 128, 64 and 32, ragged N, all-zero blocks,
   subnormal scales, exact .5 ties, the residual in place too);
   ``gather_mix_int8`` for C from 2 to 200; ``mix_accumulate`` in both
   forms bit for bit, f32 and bf16, in place into acc and into x;
   ``dequant_accumulate`` bit for bit (f32 and bf16 acc, ragged N, the
   init form, blocks 128, 64 and 32, B from 1 to 65535, in place);
   ``ssd_scan``, y and the final state, f32 and bf16, S a multiple of
   256 and S that makes the chunk halve, B 1-4, H 1-32, P and N 32-128,
   64 chunks at Mamba2's heads, H 7;
   ``weighted_mix`` bit for bit, f32 and bf16, K 1-513, N 1 to 2^24 + 3,
   device and host weights, masked, all masked, row-strided, out a row of
   the input;
4. small: the ``tiny_lm`` ``ServeLoop`` on the card against the same on
   the CPU, token for token; the ``tiny_lm`` ``SlotTrainLoop`` with a
   fail and a join on the card against the same on the CPU (alive
   sequence equal, losses within 1e-4 relative), codec-free, with
   int8-block and with int4-block; one masked round of each of the five
   codecs, card against CPU; one per-rank round of each codec at
   tiny_lm width, card against CPU;
5. slice: ``run_slots`` serving Llama-3.2-3B at full width and depth
   (random f32 weights from a seeded generator), with the launch counts
   of the kernels, then one ``decode_step`` with the kernel against the
   same with the plain attention, a breakdown of one decode tick and one
   prefill (host time against device busy time), and the kernel at the
   slice's shape, timed and checked as at ``decode_32k``;
6. ssm: ``run_batch`` serving Mamba2-370m at full width and depth (48
   layers, random f32 weights from a seeded generator), batch 4, prompt
   32768 (``prefill_32k`` with its batch cut from 32), 64 generated:
   prefill seconds and decode tok/s, ``ssd_scan`` launches (48 a
   prefill), peak memory against its reckoning, one prefill with the
   kernel against the same with the plain scan (logits and the decode
   states), a breakdown of one prefill and one decode tick, and the
   kernel alone at the slice's shape against its plain version and its
   bound (20 calls, their median and min, the SM clock before and after,
   and each of the kernel's three launches over 5 profiled calls);
7. train: the DFL round, ``SlotTrainLoop`` over Llama-3.2-3B at full
   width with its depth cut to what fits (8 slots, 7 live, a fail and a
   join, sgd, fedlay mixing through ``gather_mix``), with its checks,
   per-round times, a profiled round, and the kernel at the round's
   shape against its plain version and ``torch.matmul``, and both of
   its bodies there in turns (the gather body's output held to the
   plain version on two column chunks);
8. wire: the same round compressed, int8-block and then int4-block, at
   Llama-3.2-3B width with the depth cut to what fits beside the
   error-feedback residual and the wire, with its checks (launches per
   round, dead rows, joiner, residual reset and keep, ``data_ptr``,
   peak memory, the last round against the plain path), the codec-free
   round's losses at the same depth beside the codec's, and each new
   kernel at the round's shape against its plain version and a PyTorch
   call;
9. mesh: the per-rank mixer on a one-rank NCCL client group holding all
   8 clients (``OverlayController(mixer_kind="shard_map")``, so every
   edge is an intra-rank take): a few DFL rounds of ``dfl_local_step``
   and the per-rank int8-block round with its residual at Llama-3.2-3B
   width cut to what fits, with its checks (``dequant_accumulate`` 2L
   times a round, ``quantize_block`` and the self term once, the round
   against the global int8-block round, the codec-free per-rank round
   against ``gather_mix``, ``data_ptr``, peak memory), the codec-free
   per-rank round's losses beside, and ``dequant_accumulate`` at the
   round's shape against its plain version and two PyTorch calls;
10. front: the training front door, ``launch/train.py``: its
   ``make_dfl_step`` at Llama-3.2-3B width with the depth cut to what
   fits AdamW's state, 4 clients on the one-rank NCCL group, three
   AdamW steps of the flat round codec-free and three under int8-block
   with its residual, with their checks (the kernels' launches a step,
   the last round against the same round through the plain versions on
   the card, ``data_ptr``, AdamW's count, peak memory, finite losses)
   and the step's host time split into local step and mixing, tokens a
   second; then the command line, ``python -m repro_torch.launch.train
   --device cuda`` at tiny_lm's defaults (8 clients, 20 steps, int8-block,
   checkpoints every 5, telemetry) in a subprocess, the same run
   in-process on the script's group stopped at step 10 and resumed from
   its checkpoint, its losses and final checkpoint held to the
   subprocess's bit for bit, and the same run on the CPU, its losses held
   to the card's;
11. churn: churn, faults and scale, each path mixing through
   ``gather_mix``: (a) the re-stacking ``ChurnTrainLoop`` over
   Llama-3.2-3B at full width with its depth cut to what the re-stack
   reckoning fits, 8 seeded nodes, 8 steps under a fail, the same id's
   rejoin (a ``MixerCache`` hit) and a new id's join, with its checks
   (launches equal to the steps, rows moved by node identity bit for bit,
   each joiner's row its donor's, the last step's mixing against the
   plain version, peak memory, finite losses) and a step's host time
   split into remap, local step and mixing, beside a ``tiny_lm`` twin on
   the CPU; (b) the reference's ``fault_storm`` arms (clean, 10 % NDMP
   message loss, loss and 2 stragglers, loss and a 2-way partition with
   its heal, as the reference runs them, and that last arm again with a
   ``HealthTracker`` and a ``RepairPolicy``) over n 16 rows of 50,890
   f32 through ``SlotTrainLoop`` under a ``ChaosEngine``, each arm's
   rounds to a 1e-3 spread within 3 x the clean arm's (past the fault
   windows), the reference's partition arm mixing through partitioned
   rounds, every edge mask, ``faults_injected`` and the final rows held
   to the same arm on the CPU, and the repair latency after the heal; (c) the reference's ``cohort_stream`` at full size
   (``VectorSimulator`` over 50,000 nodes, capacity 128, K 32, 64 and
   128, 24 rounds with a 1 % fail and join burst at mid-run) with rows
   of 50,890 f32, the device round against the dense oracle, each K's
   records, park and rows held to the same calls on the CPU, the
   resident buffers' ``data_ptr``, rounds/s, remap ms and the kernel's
   device time a round (the gather body, from the device tables, no
   round matrix) against its bound, its plain version and
   ``torch.matmul``, which it must not be slower than;
12. dfl: the paper's DFL engine over Table III's three tasks, each
   aggregation one ``weighted_mix`` launch: ``Engine.run`` over
   ``MLPTask`` at its default width on MNIST's 28 x 28 input width (N =
   50,890 f32), 100 clients dealt 3 label shards each, for fedlay,
   fedlay-noconf, fedlay-sync and Table III's fedavg, gaia, chord and
   dfl-dds; then over ``CNNTask`` on CIFAR-10's 32 x 32 x 3 input width
   (N = 25,578, 100 clients x 3 label shards) and ``LSTMTask`` on 200
   role streams, two a client (N = 27,936, 100 clients), each at its
   defaults, for fedlay, fedavg, gaia and dfl-dds (chord runs for the
   MLP only, to leave the ``churn`` phase room in the time limit).  For each task
   the checks (the first SGD step's gradient on the card against an f64
   referee on the CPU, one local_train card against CPU, launches equal
   to the engine's aggregations, peak memory against its reckoning,
   cuDNN's workspace included, fedlay's accuracy rising, fedlay on the
   card against the same call on the CPU), each
   method's wall time, accuracy, messages and suppressed sends, where a
   fedlay run's host time goes and the mean of its ``engine.aggregate``
   span; one CNN and one LSTM ``local_train``'s host time, device time
   and launches; and ``weighted_mix`` at each task's wake-up shape (the
   MLP's also with rows padded to 16 bytes) and at a bandwidth shape,
   with host weights (the engine's) and device weights, its load width,
   against its plain version, its bound and ``torch.matmul``, with the
   wrapper's wall time a call at the MLP's wake-up;
13. the ``kernels`` JSON line (all nine kernels; ``gather_mix``'s launches
   those of the ``train`` and ``churn`` phases), the card's name and
   power limit, and the result line ``{"ok": true, "device": {...}}``.

Any failure raises, and the script exits non-zero without the result
line.  Without CUDA, or outside a checkout, it exits 1 at once.

``python3 chip_smoke.py --weighted-mix ROOT`` runs none of that: it times
the ``weighted_mix`` of the checkout at ROOT (this one, or another
unpacked beside it, such as the parent commit) at the DFL engine's
wake-up shape, so that two checkouts are compared in one call by
running it in turns (A, B, B, A), each turn its own process.
``python3 chip_smoke.py --front-step`` builds the kernels, opens the
group and runs only the ``front`` phase's codec-free steps, in turns
with the embedding's backward as the port has it and through indexing
(:func:`front_step_turns`); it prints no result line.
``python3 chip_smoke.py --churn`` builds the kernels and runs only the
``churn`` phase; it prints no result line either.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
#: f32 products in split TF32 on the tensor cores: three TF32 products
#: (495 TFLOP/s dense on the H100 SXM) for each f32 one
SPLIT_TF32_FLOPS_PER_S = 495e12 / 3
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


def smi(query: str) -> str:
    """The first card's ``nvidia-smi --query-gpu=<query>`` line."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


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


def decode_launches(torch, calls):
    """Every device launch of one profiled pass over ``calls`` (behind a
    GPU sleep, left out): launches seen a call, and each kernel's median
    device ms by name.  Late in a long run the profiler can drop a
    window's first events, so a count below one a call is possible; one
    above it is not."""
    from torch.profiler import ProfilerActivity, profile
    for call in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(200_000_000)
        for call in calls:
            call()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    per_call = sum(map(len, by_name.values())) / len(calls)
    return per_call, {name: sorted(ms)[len(ms) // 2] for name, ms in by_name.items()}


def measure_decode(torch, F, q, caches, pos, reps):
    """flash_decode against flash_decode_ref on the card over each (k, v)
    of ``caches``, held to :func:`decode_tol`: the worst error, the
    largest |ref|, the empty rows, two calls bit for bit, the device
    launches a call (at most one, all ``flash_decode_kernel``, checked)
    and their profiled ms, and the kernel, plain, bound and library times of one
    call (``reps`` passes over the caches for the kernel, a tenth of that
    for the others) with the wrapper's wall time per call."""
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
        check(torch.equal(out, flash_decode(q, k, v, pos)),
              "two flash_decode calls on the same inputs differ")
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
    per_call, launch_ms = decode_launches(torch, kernel_calls)
    check(0 < per_call <= 1 and all("flash_decode_kernel" in name for name in launch_ms),
          f"flash_decode calls made {per_call} device launches each: {launch_ms}")
    few = max(1, reps // 10)
    bound_ms, bound_by = decode_bound(q, caches[0][0], pos_list, L)
    ms = device_ms(torch, kernel_calls, reps)
    return {"max_abs_err": err, "ref_max": ref_max, "empty_rows": len(empty),
            "ms": ms, "share": bound_ms / ms, "per_call": per_call,
            "launch_ms": launch_ms,
            "host_ms": host_ms(torch, kernel_calls[0], 100),
            "plain_ms": device_ms(torch, [call(flash_decode_ref, k, v)
                                          for k, v in caches], few),
            "library_ms": device_ms(torch, [library(k, v) for k, v in caches], few),
            "bound_ms": bound_ms, "bound_by": bound_by}


def decode_line(m, card) -> str:
    """The timing part of a flash_decode line of :func:`measure_decode`."""
    launches = ", ".join(
        f"{name.replace('void ', '').replace('(anonymous namespace)::', '').split('(')[0]}"
        f" {ms:.4f} ms" for name, ms in m["launch_ms"].items())
    return (f"device time per call: kernel {m['ms']:.4f} ms, plain "
            f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
            f"({m['bound_by']}; {100 * m['share']:.1f} % of it reached), SDPA "
            f"{m['library_ms']:.4f} ms; profiled device launches a call "
            f"{m['per_call']:g}, each {launches}; two calls the same bits; wall per kernel "
            f"call {m['host_ms']:.4f} ms ({card})")


#: flash_decode_kernel's instantiations on the main path: (q, kv dtype,
#: head_dim, GM), the slice's f32 and decode_32k's bf16 at Llama-3.2-3B's
#: head_dim 128 and group of 3 (GM 4)
DECODE_MAIN = {("f32", "f32", 128, 4), ("bf16", "bf16", 128, 4)}


def report_flash_decode_build(log: str) -> None:
    """One line per flash_decode_kernel instantiation from ``nvcc -Xptxas
    -v``: registers and spill bytes, the main path's marked (both must be
    in the log)."""
    import re
    entry, spills, seen = None, (0, 0), set()
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m[1]), int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        t = entry and re.search(r"flash_decode_kernelI(.+?)Li(\d)ELi(\d+)E", entry)
        if m and t:
            kinds = re.sub(r"13__nv_bfloat16|S\d*_", "b", t[1])
            key = tuple("bf16" if c == "b" else "f32" for c in kinds) + (
                32 * int(t[2]), int(t[3]))
            main = key in DECODE_MAIN
            seen.add(key)
            print(f"build: flash_decode_kernel<q {key[0]}, kv {key[1]}, head_dim "
                  f"{key[2]}, GM {key[3]}>: {m[1]} registers, spill stores "
                  f"{spills[0]} B, loads {spills[1]} B" + (" (main path)" if main else ""))
    check(DECODE_MAIN <= seen, f"ptxas reported no {DECODE_MAIN - seen}")


#: weighted_mix_kernel's instantiation on the main path: (dtype, VEC,
#: weights), the engine's wake-up (f32 rows 8 bytes off the 16-byte grid,
#: host weights carried in the launch)
WMIX_MAIN = ("f32", 2, "by value")


def report_weighted_mix_build(log: str) -> None:
    """One line for weighted_mix's instantiations from ``nvcc -Xptxas -v``:
    how many, their most registers and their spill bytes, and the main
    path's registers and spills (it must be in the log and spill
    nothing)."""
    import re
    entry, spills, found = None, (0, 0), {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m[1]), int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        t = entry and re.search(
            r"weighted_mix_kernelI(f|13__nv_bfloat16)Li(\d+)E.*?(ByValue|ByPointer)", entry)
        if m and t:
            key = ("f32" if t[1] == "f" else "bf16", int(t[2]),
                   "by value" if t[3] == "ByValue" else "by pointer")
            found[key] = (int(m[1]), *spills)
    check(WMIX_MAIN in found, f"ptxas reported no weighted_mix_kernel {WMIX_MAIN}")
    regs, stores, loads = found[WMIX_MAIN]
    check(stores == loads == 0, f"the main path's weighted_mix_kernel spills {stores} / "
                                f"{loads} B")
    print(f"build: weighted_mix_kernel: {len(found)} instantiations (dtype x load width "
          f"x weights by value or pointer), at most "
          f"{max(r for r, _, _ in found.values())} registers, spill stores "
          f"{sum(v[1] for v in found.values())} B, loads "
          f"{sum(v[2] for v in found.values())} B in all; main path <{', '.join(map(str, WMIX_MAIN))}>: "
          f"{regs} registers, no spills")


def report_gather_mix_build(log: str) -> None:
    """One line per gather_mix body from ``nvcc -Xptxas -v``: how many
    instantiations, their most registers and their spill bytes.  The
    gather body's launch plan counts on GATHER_MIN_BLOCKS blocks of
    GATHER_THREADS an SM, so every instantiation must fit that many in
    the SM's 65,536 registers, and the cohort round's <f32, 8 B> must be
    in the log and spill nothing."""
    import re
    from repro_torch.kernels.gather_mix import GATHER_MIN_BLOCKS, GATHER_THREADS
    entry, spills, found = None, (0, 0), {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m[1]), int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        t = entry and re.search(r"gather_mix_(gather|reg)I(f|13__nv_bfloat16)((?:Li\d+E)+)",
                                entry)
        if m and t:
            key = (t[1], "f32" if t[2] == "f" else "bf16",
                   *map(int, re.findall(r"\d+", t[3])))
            found[key] = (int(m[1]), *spills)
    budget = 65_536 // (GATHER_MIN_BLOCKS * GATHER_THREADS)
    main = ("gather", "f32", 8)
    check(main in found, f"ptxas reported no gather_mix_gather<{main[1]}, {main[2]}>")
    for body, name in (("reg", "register"), ("gather", "gather")):
        got = {k: v for k, v in found.items() if k[0] == body}
        if not got:
            continue
        regs = max(v[0] for v in got.values())
        stores, loads = sum(v[1] for v in got.values()), sum(v[2] for v in got.values())
        line = (f"build: gather_mix's {name} body: {len(got)} instantiations, at most "
                f"{regs} registers, spill stores {stores} B, loads {loads} B")
        if body == "gather":
            check(regs <= budget, f"gather_mix_gather takes {regs} registers, above the "
                                  f"{budget} that {GATHER_MIN_BLOCKS} blocks of "
                                  f"{GATHER_THREADS} an SM allow")
            r, st, ld = found[main]
            check(st == ld == 0, f"gather_mix_gather<f32, 8 B> spills {st} / {ld} B")
            line += (f" (budget {budget}: {GATHER_MIN_BLOCKS} blocks of {GATHER_THREADS} an "
                     f"SM); the cohort round's <f32, 8 B>: {r} registers, no spills")
        print(line)


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
          + decode_line(m, card))


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


def profiled(torch, fn, repeats: int = 3, counts=None):
    """Host time of ``fn`` (mean of ``repeats`` synchronised calls), and
    one profiled call's device time per kernel name, in ms; its launches
    per kernel name go into ``counts`` where one is given."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / repeats
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a lead-in on the device (about 0.1 s), left out of the sums: late
        # in a long run the trace dropped the first tens of ms of kernels
        # of the window (a full-width mixing round lost its first three)
        torch.cuda._sleep(200_000_000)
        fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in ev.key:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us / 1e3
            if counts is not None:
                counts[ev.key] = counts.get(ev.key, 0) + ev.count
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
          f"max abs err {m['max_abs_err']:.3e} (tol 1e-5); " + decode_line(m, card))
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:98",
            "launches": launches, "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"]}


# --------------------------------------------------------------------------
# Mamba2 serving: the SSD scan
# --------------------------------------------------------------------------

#: (B, S, H, P, N, chunk): S a multiple of 256 and S that makes Q halve
#: (96, 7, 300 at chunk 16), B 1 to 4, H 1 to 32, P and N 32 to 128; 64
#: chunks at Mamba2's heads (A down to -32: the state passed along a long
#: chain), and an H of 7 (no multiple of the kernel's groups of 2 and 4 heads)
SSD_CASES = [(1, 256, 1, 64, 64, 256), (2, 512, 4, 64, 128, 256),
             (1, 96, 3, 128, 64, 256), (4, 7, 32, 64, 128, 256),
             (3, 768, 2, 128, 128, 256), (4, 1024, 32, 64, 128, 256),
             (2, 300, 5, 32, 32, 16), (1, 16384, 32, 64, 128, 256),
             (2, 512, 7, 64, 128, 256)]
#: ssd_scan's per-head limit, in units of 2^-24·cs_h·max|ref_h| (see
#: ssd_assert_close; tests/test_torch_cuda.py:assert_ssd_close uses the same)
SSD_CS_FACTOR = 8
SSM_BATCH, SSM_PROMPT, SSM_GEN = 4, 32768, 64


def ssd_inputs(torch, gen, B, S, H, P, N, dtype):
    """The mixer's ranges: dt a softplus of N(0, 1), A = -(1..H) (the
    init's -exp(A_log)), x, B and C N(0, 1)."""
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device="cuda"))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device="cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return randn(B, S, H, P), dt, A, randn(B, S, N), randn(B, S, N)


def ssd_assert_close(torch, got, ref, dt, A, Q, head_dim):
    """Hold ssd_scan's y (head_dim 2) or final state (head_dim 1) to its
    plain version, head by head: |got - ref| <= rtol·|ref| + (base +
    8·2^-24·cs_h)·max|ref_h|, with cs_h the largest |within-chunk cumsum
    of dt·A_h|.  Both sides form each decay exp(cs_i - cs_j) from such a
    cumsum, whose rounding shifts the exponent by a few 2^-24·|cs|: y and
    the state carry a relative error of that size, large for heads with a
    large |A| (|cs| reaches 6,000 at the slice's shape).  Against a
    float64 evaluation on the CPU the plain version's own error read at
    most 0.6·2^-24·cs_h·max|y_h|, and the card's kernel against it at
    most 0.87 (f32) and 1.47 (bf16 state) times 2^-24·cs_h·max|ref_h|
    over SSD_CASES (PERF.md §6): SSD_CS_FACTOR, 8, is about 5x the
    largest.  base: 1e-5 for the f32 sums in another order; bf16 y adds
    1e-2 (base and rtol) for its one rounding to bf16.  Returns max |got - ref| / max |ref| and
    the largest per-head |got - ref| / (2^-24·cs_h·max|ref_h|)."""
    B, S, H = dt.shape
    cs = (dt * A).reshape(B, S // Q, Q, H).sum(2).abs().amax(dim=(0, 1))
    bf16 = got.dtype == torch.bfloat16
    base, rtol = (1e-2, 1e-2) if bf16 else (1e-5, 0.0)
    g, r = got.float().movedim(head_dim, 0), ref.float().movedim(head_dim, 0)
    scale = r.abs().reshape(H, -1).amax(dim=1)
    limit = (base + SSD_CS_FACTOR * 2.0 ** -24 * cs) * scale
    diff = (g - r).abs()
    excess = (diff - rtol * r.abs()).reshape(H, -1).amax(dim=1) - limit
    check(bool((excess <= 0).all()),
          f"ssd_scan {'y' if head_dim == 2 else 'state'} off its plain version in "
          f"heads {(excess > 0).nonzero().flatten().tolist()} by up to "
          f"{excess.max().item():.3e} over the limit")
    ratio = diff.reshape(H, -1).amax(dim=1) / (2.0 ** -24 * cs * scale).clamp_min(1e-30)
    return (diff.max() / r.abs().max()).item(), ratio.max().item()


def check_ssd_scan(torch):
    """ssd_scan (y and the final state) against ssd_chunked_ref on the
    card, f32 and bf16, over SSD_CASES, held to ssd_assert_close; a
    failure raises.  Returns the worst relative errors."""
    from repro_torch.kernels.ref import chunk_len, ssd_chunked_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, P, N, chunk in SSD_CASES:
            x, dt, A, Bm, Cm = ssd_inputs(torch, gen, B, S, H, P, N, dtype)
            out = torch.full((B, H, P, N), float("nan"), device="cuda")
            y, _ = ssd_scan(x, dt, A, Bm, Cm, chunk, state_out=out)
            ref, final = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
            torch.cuda.synchronize()
            Q = chunk_len(S, chunk)
            for what, a, b, hd in (("y", y, ref, 2), ("state", out, final, 1)):
                key = f"{what} {str(dtype).split('.')[1]}"
                err, ratio = ssd_assert_close(torch, a, b, dt, A, Q, hd)
                e0, r0 = worst.get(key, (0.0, 0.0))
                worst[key] = (max(e0, err), max(r0, ratio))
    print("kernels: ssd_scan against its plain version over "
          f"{len(SSD_CASES)} shapes (B 1-4, H 1-32, P and N 32-128, Q 256, 96, "
          "7, 4): max |err| / max|ref|, and the largest per-head |err| over "
          "2^-24·cs_h·max|ref_h|: " + ", ".join(
              f"{k} {e:.3e} ({r:.2f})" for k, (e, r) in worst.items())
          + f" (limits per head: f32 (1e-5 + {SSD_CS_FACTOR}·2^-24·cs_h)·max|ref_h|, "
          f"bf16 y 1e-2·|ref| + (1e-2 + {SSD_CS_FACTOR}·2^-24·cs_h)·max|ref_h|)")
    return worst


def ssd_bound(B, S, H, P, N, Q, itemsize):
    """Least time for the scan on these shapes: x, dt, A, B and C read
    once, y and the final state written once, against the causal dual
    form's operations: 2·N·Q(Q+1)/2 for C·Bᵀ once per (b, chunk), since
    every head shares it (single group), and per (b, h, chunk) 2·P·Q(Q+1)/2
    for its product with dt·x, 2·Q·N·P for the inter-chunk term and 2·Q·N·P
    for the state update, at the split-TF32 rate of the tensor cores that
    the kernel runs them on.  Also returns the per-head bound, C·Bᵀ once
    per head at the f32 rate of the CUDA cores, as the kernel's earlier
    rows of PERF.md count it."""
    nbytes = (2 * B * S * H * P * itemsize + 4 * B * S * H + 4 * H
              + 2 * B * S * N * itemsize + 4 * B * H * P * N)
    tri, nc = Q * (Q + 1) // 2, S // Q
    ops = B * nc * 2 * tri * N + B * H * nc * (2 * tri * P + 4 * Q * N * P)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / SPLIT_TF32_FLOPS_PER_S
    per_head = B * H * nc * (2 * tri * (N + P) + 4 * Q * N * P)
    old_ms = max(t_b, per_head / F32_FLOPS_PER_S) * 1e3
    return (max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"), ops,
            old_ms, per_head)


def ssd_passes(torch, call, calls: int = 5) -> dict:
    """Device ms of each of ssd_scan's three launches: the median over
    ``calls`` profiled calls, each kernel event taken alone (late in a long
    run the trace can drop a window's first kernels, which a sum would
    hide)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(200_000_000)
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    out = {}
    for name in ("chunk_state", "state_pass", "chunk_scan"):
        us = sorted(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name)
        check(len(us) > 0, f"the profiler saw no {name} launch")
        out[name] = us[len(us) // 2] / 1e3
    return out


def time_ssd_scan(torch, card, B, S, H, P, N, chunk, reps=20):
    """ssd_scan f32 alone at one shape, on the mixer's ranges: held to its
    plain version (ssd_assert_close), then ``reps`` calls queued back to
    back behind a GPU sleep, as in device_ms, with a CUDA event between
    each call and the next, so that each call's device time is read alone
    and the host's enqueueing does not show (the inputs, over 1 GB at the
    slice's shape, find the 50 MB L2 cold), with nvidia-smi's SM clock
    read before and after; the plain version once; each of the three
    launches' median over 5 profiled calls.
    Returns the kernel's row of the ``kernels`` line
    (``ms`` the median call) with ``launches`` left for the caller."""
    from repro_torch.kernels.ref import chunk_len, ssd_chunked_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    Q = chunk_len(S, chunk)
    x, dt, A, Bm, Cm = ssd_inputs(torch, torch.Generator(device="cuda").manual_seed(6),
                                  B, S, H, P, N, torch.float32)
    out = torch.empty((B, H, P, N), device="cuda")
    y, _ = ssd_scan(x, dt, A, Bm, Cm, chunk, state_out=out)
    ref, final = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    rel = (ssd_assert_close(torch, y, ref, dt, A, Q, 2),
           ssd_assert_close(torch, out, final, dt, A, Q, 1))
    err = max((y - ref).abs().max().item(), (out - final).abs().max().item())
    del ref, final, y
    clock_before = smi("clocks.sm,power.draw,temperature.gpu")
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(200_000_000)          # ~0.1 s while the host queues
    events[0].record()
    for event in events[1:]:
        ssd_scan(x, dt, A, Bm, Cm, chunk, state_out=out)
        event.record()
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    clock_after = smi("clocks.sm,power.draw,temperature.gpu")
    passes = ssd_passes(torch, lambda: ssd_scan(x, dt, A, Bm, Cm, chunk, state_out=out))
    times.sort()
    ms, ms_min = times[len(times) // 2], times[0]
    plain_ms = device_ms(torch, [lambda: ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)], 1)
    bound_ms, bound_by, ops, old_ms, per_head = ssd_bound(B, S, H, P, N, Q, 4)
    print(f"ssm: ssd_scan f32 at x ({B}, {S}, {H}, {P}), N {N}, Q {Q}: device time "
          f"per call over {reps} calls: median {ms:.3f} ms, min {ms_min:.3f}, max "
          f"{times[-1]:.3f} ({ops / ms / 1e9:.1f} TFLOP/s of the dual form's "
          f"{ops / 1e9:.1f} GFLOP, C·Bᵀ once per (b, chunk)); plain {plain_ms:.3f} ms; "
          f"bound {bound_ms:.3f} ms ({bound_by}, split TF32 at "
          f"{SPLIT_TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s; {100 * bound_ms / ms:.1f} % of it), "
          f"per-head count {old_ms:.3f} ms ({per_head / 1e9:.1f} GFLOP at "
          f"{F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s; {100 * old_ms / ms:.1f} %); library none; "
          f"max abs err {err:.3e} (y {rel[0][0]:.3e}, state {rel[1][0]:.3e} of "
          f"max|ref|; per head {rel[0][1]:.2f} and {rel[1][1]:.2f} x "
          f"2^-24·cs_h·max|ref_h|); SM clock, power, temperature before "
          f"[{clock_before}], after [{clock_after}] ({card})")
    print("ssm: ssd_scan's three launches, median device ms over 5 profiled calls: "
          + ", ".join(f"{name} {ms:.3f}" for name, ms in passes.items()))
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:76",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def ssm_reckoned(cfg, B, S) -> tuple:
    """Device bytes a Mamba2 prefill of B x S tokens adds to the weights
    at its peak, in the last step of a layer's mixer (the gate's rmsnorm):
    the resident cache (state and conv tail of every layer), and that
    layer's x and normed input (D each), the in_proj output (2·di + 2N +
    H), the conv output (di + 2N), dt after softplus (H), y and the
    rmsnorm's two temporaries (di each), f32 per token."""
    s = cfg.ssm
    D, di, n = cfg.d_model, s.d_inner(cfg.d_model), s.d_state
    nh = s.nheads(D)
    cache = cfg.num_layers * B * (nh * s.headdim * n + (s.d_conv - 1) * (di + 2 * n)) * 4
    act = 4 * B * S * (2 * D + (2 * di + 2 * n + nh) + (di + 2 * n) + nh + 3 * di)
    return cache, act


def phase_ssm(torch, card):
    """Mamba2-370m served by run_batch at full width and depth: launches,
    memory, the kernel against the plain path end to end, a breakdown,
    and the kernel alone at the slice's shape.  The prefill through the
    kernel is held to the same prefill through the plain scan at 1e-3 of
    max|ref| for the last-token logits, the 48 layers' states and their
    conv tails (the first layer's tail exactly): each layer's scan
    differs by the decay rounding (ssd_assert_close), about 1e-5 of a
    head's scale, and the layers carry it on; a CPU run at full width
    and depth read 5e-6 between two chunk sizes."""
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import ssd_scan as scan_mod
    from repro_torch.kernels.ref import ssd_chunked_ref
    from repro_torch.launch.serve import run_batch
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.model import (LanguageModel, decode_step, init_cache,
                                          prefill)
    ssd_scan = scan_mod.ssd_scan

    cfg = REGISTRY["mamba2-370m"]
    s = cfg.ssm
    t0 = time.perf_counter()
    model = LanguageModel(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"ssm: {cfg.name} {cfg.num_layers} layers, d_model {cfg.d_model}, d_inner "
          f"{s.d_inner(cfg.d_model)}, {s.nheads(cfg.d_model)} heads of {s.headdim}, "
          f"d_state {s.d_state}, d_conv {s.d_conv}, chunk {s.chunk}, vocab "
          f"{cfg.vocab_size} (padded {cfg.padded_vocab}, tied): {n_params / 1e6:.2f} M "
          f"f32 parameters ({4 * n_params / 1e9:.3f} GB), drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    args = argparse.Namespace(batch=SSM_BATCH, prompt_len=SSM_PROMPT, gen=SSM_GEN)
    # warm-up: cuBLAS handles and workspaces
    run_batch(cfg, model, argparse.Namespace(batch=SSM_BATCH, prompt_len=512, gen=4),
              np.random.default_rng(1))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ssd_scan.launches = 0
    res = run_batch(cfg, model, args, np.random.default_rng(0))
    launches = ssd_scan.launches
    peak = torch.cuda.max_memory_allocated()
    cache_b, act_b = ssm_reckoned(cfg, SSM_BATCH, SSM_PROMPT)
    reckoned = base + cache_b + act_b
    check(launches == cfg.num_layers,
          f"ssd_scan launches {launches} != {cfg.num_layers} (one prefill)")
    check(peak <= reckoned * (1 + PEAK_MARGIN),
          f"peak {peak / 1e9:.3f} GB over the reckoned {reckoned / 1e9:.3f} GB")
    print(f"ssm: run_batch, batch {SSM_BATCH}, prompt {SSM_PROMPT}, {SSM_GEN} generated: "
          f"prefill {res['prefill_s']:.3f} s ({SSM_BATCH * SSM_PROMPT / res['prefill_s']:.0f}"
          f" tok/s), decode {res['tok_s']:.1f} tok/s ({res['decode_s']:.3f} s); "
          f"ssd_scan launches {launches} = {cfg.num_layers} layers x 1 prefill; peak "
          f"{peak / 1e9:.3f} GB <= reckoned {reckoned / 1e9:.3f} GB x {1 + PEAK_MARGIN} "
          f"(allocated before {base / 1e9:.3f} GB + cache {cache_b / 1e9:.3f} GB + "
          f"the prefill's peak layer {act_b / 1e9:.3f} GB) ({card})")

    # the same prefill through the kernel and through the plain version
    tokens = torch.randint(0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(5))

    def plain_scan(x, dt, A, Bm, Cm, chunk=256, state_out=None):
        y, final = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
        return y, state_out.copy_(final)

    runs = []
    with torch.no_grad():
        for scan in (ssd_scan, plain_scan):
            ssm_mod.ssd_scan = scan
            try:
                before = ssd_scan.launches
                cache = init_cache(model, SSM_BATCH, SSM_PROMPT + SSM_GEN)
                logits, _ = prefill(model, cache, tokens)
                torch.cuda.synchronize()
                runs.append((logits, cache, ssd_scan.launches - before))
            finally:
                ssm_mod.ssd_scan = ssd_scan
            gc.collect()
            torch.cuda.empty_cache()
    (lk, ck, nk), (lp, cp, np_) = runs
    check(nk == cfg.num_layers and np_ == 0, f"launches {nk} / {np_} in the two prefills")
    check(bool(torch.isfinite(lk).all()), "non-finite prefill logits")
    valid = slice(0, cfg.vocab_size)
    err = (lk[:, valid] - lp[:, valid]).abs().max().item()
    scale = lp[:, valid].abs().max().item()
    check(err <= 1e-3 * scale, f"prefill logits differ by {err} (scale {scale})")
    s_err = (ck["state"] - cp["state"]).abs().max().item()
    s_scale = cp["state"].abs().max().item()
    check(s_err <= 1e-3 * s_scale, f"decode states differ by {s_err} (scale {s_scale})")
    # the first layer's conv tail is its input's, the same on both paths;
    # a later layer's carries the earlier layers' differences
    c_err = (ck["conv"] - cp["conv"]).abs().max().item()
    c_scale = cp["conv"].abs().max().item()
    check(torch.equal(ck["conv"][0], cp["conv"][0]) and c_err <= 1e-3 * c_scale,
          f"conv tails differ by {c_err} (scale {c_scale})")
    print(f"ssm: prefill of {SSM_BATCH} x {SSM_PROMPT} tokens, kernel vs plain "
          f"ssd_chunked_ref in every layer: max abs logit err {err:.3e} <= 1e-3 x "
          f"{scale:.3f}; the {cfg.num_layers} layers' states max abs err {s_err:.3e} "
          f"<= 1e-3 x {s_scale:.3f}, conv tails {c_err:.3e} <= 1e-3 x {c_scale:.3f} "
          f"(the first layer's equal)")
    del lp, cp, runs

    # breakdown of one prefill and one decode tick
    cache = ck
    wall, kernels = profiled(torch, lambda: prefill(model, cache, tokens), repeats=1)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"breakdown: ssm prefill of {SSM_BATCH} x {SSM_PROMPT}: host {wall:.1f} ms, "
          f"device busy {busy:.1f} ms ({100 * busy / wall:.1f} %), idle share "
          f"{100 * (1 - busy / wall):.1f} % ({card})")
    print("breakdown: ssm prefill kernels (ms): " + "; ".join(
        f"{name[:60]} {ms:.2f}" for name, ms in top))
    tok = torch.argmax(lk, dim=-1, keepdim=True).to(torch.int32)
    wall, kernels = profiled(torch, lambda: decode_step(model, cache, tok))
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"breakdown: ssm decode tick at batch {SSM_BATCH}: host {wall:.2f} ms, device "
          f"busy {busy:.2f} ms ({100 * busy / wall:.1f} %), idle share "
          f"{100 * (1 - busy / wall):.1f} % ({card})")
    print("breakdown: ssm tick kernels (ms): " + "; ".join(
        f"{name[:60]} {ms:.3f}" for name, ms in top))
    del cache, ck, lk
    gc.collect()
    torch.cuda.empty_cache()

    # the kernel alone at the slice's shape
    entry = time_ssd_scan(torch, card, SSM_BATCH, SSM_PROMPT, s.nheads(cfg.d_model),
                          s.headdim, s.d_state, s.chunk)
    entry["launches"] = launches
    return entry


# --------------------------------------------------------------------------
# The DFL training round
# --------------------------------------------------------------------------

TRAIN_CAPACITY, TRAIN_LIVE, TRAIN_SEQ, TRAIN_ROUNDS = 8, 7, 1024, 6
TRAIN_CHURN = [(1.5, "fail", 3), (3.5, "join", 70, 0)]
CHUNK = 1 << 24            # columns per chunk when the plain version runs
#: What a phase's reckoning of device memory leaves out, as a share of it:
#: the allocator's block rounding, the cuBLAS workspace, the schedule's
#: tables, the batch, the gradient norm.  peak <= reckoned x (1 + margin)
#: is checked.
PEAK_MARGIN = 0.02


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


#: gather_mix's checked shapes: the register body up to C 24, the gather
#: body above, the cohort round's (128, 50,890) f32 rows 8 bytes past a
#: 16-byte boundary every other row, and C at the gather body's limit
GATHER_CHECKS = [(2, 1), (3, 130), (8, 4096), (8, 1001), (16, 2050), (24, 1001), (32, 777),
                 (33, 4096),
                 (64, 3001), (200, 1000), (128, 50_890), (128, 50_891), (300, 1001),
                 ("limit", 33)]
#: the register body's threshold: both bodies timed at these C (the
#: register body holds at most 32 rows), at the cohort round's N and two
#: larger
THRESHOLD_CS, THRESHOLD_KS, THRESHOLD_NS = (16, 24, 28, 32, 64), (5, 7), (50_890, 1 << 20,
                                                                          1 << 23)


def plan_name(plan) -> str:
    if plan.body == "register":
        return f"register {plan.width} B"
    table = "table in shared memory" if plan.table else "table in device memory"
    return (f"gather {plan.tile} x {plan.stages} stages {plan.width} B, {table}, "
            f"{plan.blocks} blocks")


def check_gather_mix(torch, card):
    """gather_mix against gather_mix_ref on the card, held to mix_tol:
    f32 and bf16, C from 2 to the gather body's limit (registers up to
    24, the gather body above), ragged N, numpy and tensor sources, an
    output that is the input (bit for bit the out-of-place result), C one
    above the limit refused; then both bodies timed where the register
    body's threshold lies."""
    from repro_torch.kernels.gather_mix import (GATHER_MAX_C, REGISTER_MAX_C, REGISTER_ROWS,
                                                _sm_count,
                                                gather_mix, gather_plan, launch,
                                                launch_plan, register_plan)
    from repro_torch.kernels.ref import gather_mix_ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst, bodies = {}, {}
    sms = _sm_count(0)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        worst[name] = 0.0
        for C, N in GATHER_CHECKS:
            C = GATHER_MAX_C if C == "limit" else C
            buf = torch.randn((C, N), generator=gen, device="cuda").to(dtype)
            srcs, w = mix_table(torch, gen, C, 7 if C > REGISTER_MAX_C else 5)
            ref = gather_mix_ref(buf, srcs, w)
            for s in (srcs, srcs.cpu().numpy()):
                out = gather_mix(buf, s, w)
                torch.testing.assert_close(out.float(), ref.float(), **mix_tol(buf))
                worst[name] = max(worst[name], (out.float() - ref.float()).abs().max().item())
            inplace = buf.clone()
            check(gather_mix(inplace, srcs, w, out=inplace) is inplace,
                  "gather_mix did not return its out buffer")
            check(torch.equal(inplace, out), "gather_mix in place differs")
            plan = launch_plan(C, srcs.shape[1], N, buf.element_size(), buf.data_ptr(),
                               out.data_ptr(), sms)
            bodies[f"{name} ({C}, {N})"] = plan_name(plan)
    torch.cuda.synchronize()
    over = GATHER_MAX_C + 1
    try:
        gather_mix(torch.zeros((over, 8), device="cuda"),
                   torch.zeros((over, 1), dtype=torch.int32, device="cuda"),
                   torch.ones((over, 1), device="cuda"))
    except ValueError:
        pass
    else:
        check(False, f"gather_mix took C = {over}")
    print(f"kernels: gather_mix on C in 2..{GATHER_MAX_C}, ragged N, numpy and tensor "
          f"sources, in place: max abs err f32 {worst['float32']:.3e} (tol 1e-6 x "
          f"max|buf|), bf16 {worst['bfloat16']:.3e} (tol 2^-7 |ref| + 1e-6 "
          f"max|buf|); in place == out of place bit for bit; C {over} raises")
    print("kernels: gather_mix bodies: " + "; ".join(f"{k} {v}" for k, v in bodies.items()))
    said = []
    for C in THRESHOLD_CS:
        for N in THRESHOLD_NS:
            buf = torch.randn((C, N), generator=gen, device="cuda")
            out = torch.empty_like(buf)
            cols = [slice(0, 65_536), slice(max(0, N - 65_536), N)]
            for K1 in THRESHOLD_KS:
                srcs, w = mix_table(torch, gen, C, K1)
                srcs = srcs.int()
                refs = [gather_mix_ref(buf[:, c], srcs, w) for c in cols]
                at = (buf.data_ptr(), out.data_ptr(), sms)
                plans = [gather_plan(C, K1, N, 4, *at)]
                if C <= REGISTER_ROWS:
                    plans.insert(0, register_plan(C, N, 4, *at))
                times = []
                for plan in plans:
                    launch(buf, srcs, w, out, plan)
                    for c, ref in zip(cols, refs):
                        torch.testing.assert_close(out[:, c], ref, **mix_tol(buf))
                    reps = max(5, min(50, int(2e9 / (C * N * 8))))
                    ms = device_ms(torch, [lambda: launch(buf, srcs, w, out, plan)], reps)
                    times.append(f"{plan.body} {ms:.4f}")
                said.append(f"C {C} N {N} K1 {K1}: " + ", ".join(times))
            del buf, out
    print(f"kernels: gather_mix bodies, f32, device tables, device ms a call (each call "
          f"one launch; the register body holds at most {REGISTER_ROWS} rows and the plan "
          f"takes it up to C {REGISTER_MAX_C}): "
          + "; ".join(said) + f" ({card})")


def bits(t):
    """A tensor's bit pattern, so that equality is bit for bit (-0 != 0)."""
    import torch
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def wire_rows(torch, gen, B, N, block, levels):
    """(B, N) f32 rows on the card, row magnitudes from 1e-3 to 10; when N
    allows, row 0 holds an all-zero block, a block of exact .5 ties (max
    levels / 2 gives the scale 0.5, and the entries are odd multiples of
    0.25) and two blocks whose scale is subnormal (max 1e-37 and 2e-38)."""
    x = torch.randn((B, N), generator=gen, device="cuda")
    x *= torch.logspace(-3, 1, B, device="cuda")[:, None]
    if N >= 4 * block:
        k = torch.arange(block, device="cuda", dtype=torch.float32)
        tie = (k % 7) * 0.5 + 0.25
        tie[0] = levels / 2
        lin = torch.linspace(-1, 1, block, device="cuda")
        x[0, :block] = 0.0
        x[0, block:2 * block] = tie * torch.where(k % 2 == 1, -1.0, 1.0)
        x[0, 2 * block:3 * block] = 1e-37 * lin
        x[0, 3 * block:4 * block] = 2e-38 * lin
    return x


def check_wire_kernels(torch):
    """The wire codec's kernels and mix_accumulate against their plain
    versions on the card.  quantize_block (q, scales, residual) and
    dequantize_block bit for bit: IEEE arithmetic on both sides, with
    subnormals kept.  gather_mix_int8 within 1e-6 x max|dequant| (f32
    sums in another order).  mix_accumulate in both forms bit for bit
    (the kernel's fused multiply-add and the plain version's exact sum
    both round once to f32)."""
    from repro_torch.kernels.mix_accumulate import mix_accumulate
    from repro_torch.kernels.ref import (dequantize_block_ref, gather_mix_int8_ref,
                                         mix_accumulate_ref, quantize_block_ref)
    from repro_torch.kernels.wire_codec import (dequantize_block, gather_mix_int8,
                                                quantize_block)
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = subnormal = 0
    for levels in (127, 7):
        for block in (128, 64, 32):
            for B, N in [(1, 1), (3, 1000), (8, 4096 + 37), (5, 3 * 128 * 64)]:
                x = wire_rows(torch, gen, B, N, block, levels)
                qr, sr, rr = quantize_block_ref(x, block, levels, True)
                q, s, r = quantize_block(x, block=block, levels=levels,
                                         with_residual=True)
                check(torch.equal(q, qr) and torch.equal(bits(s), bits(sr))
                      and torch.equal(bits(r), bits(rr)),
                      f"quantize_block differs at levels {levels}, block {block}, "
                      f"({B}, {N})")
                q2, s2 = quantize_block(x, block=block, levels=levels)
                check(torch.equal(q2, qr) and torch.equal(bits(s2), bits(sr)),
                      "quantize_block without the residual differs")
                xi = x.clone()
                out = quantize_block(xi, block=block, levels=levels, with_residual=True,
                                     q_out=q2, scales_out=s2, residual_out=xi)
                check(out[2] is xi and out[0] is q2 and torch.equal(bits(xi), bits(rr)),
                      "quantize_block's residual in place differs")
                subnormal += int(((sr.float() > 0) & (sr.float() < 1.1754944e-38)).sum())
                d = dequantize_block(q, s, block=block)
                check(torch.equal(bits(d), bits(dequantize_block_ref(q, s, block))),
                      f"dequantize_block differs at block {block}")
                narrow = torch.empty((B, N), device="cuda")
                check(dequantize_block(q, s, block=block, out=narrow) is narrow
                      and torch.equal(bits(narrow), bits(d[:, :N])),
                      "dequantize_block into an N-wide out differs")
                cases += 1
    # a row-strided view: the residual written over rows of a wider buffer
    wide = torch.randn((4, 5000), generator=gen, device="cuda")
    view = wide[:, 100:4196]
    qr, sr, rr = quantize_block_ref(view, 128, 127, True)
    q, s, r = quantize_block(view, with_residual=True, residual_out=view)
    check(r is view and torch.equal(q, qr) and torch.equal(bits(view), bits(rr)),
          "quantize_block on a row-strided view differs")

    worst_g = 0.0
    for block in (128, 64, 32):
        for C, N in [(2, 1), (3, 130), (8, 4096), (8, 1001), (16, 2050), (32, 777),
                     (33, 4096), (64, 3001), (200, 1000)]:
            x = torch.randn((C, N), generator=gen, device="cuda")
            q, s = quantize_block(x, block=block)
            srcs, w = mix_table(torch, gen, C, 5)
            ref = gather_mix_int8_ref(q, s, srcs, w, block)
            tol = 1e-6 * dequantize_block_ref(q, s, block).abs().max().item()
            for src in (srcs, srcs.cpu().numpy()):
                out = gather_mix_int8(q, s, src, w, block=block)
                torch.testing.assert_close(out, ref, rtol=0.0, atol=tol)
                worst_g = max(worst_g, (out - ref).abs().max().item())
            narrow = torch.empty((C, N), device="cuda")
            check(gather_mix_int8(q, s, srcs, w, block=block, out=narrow) is narrow
                  and torch.equal(narrow, out[:, :N]),
                  "gather_mix_int8 into an N-wide out differs")

    for dta, dtx in [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                     (torch.float32, torch.bfloat16)]:
        for B, N in [(1, 1), (3, 1001), (8, 4096), (7, 3 * 2 ** 16 + 5)]:
            acc = torch.randn((B, N), generator=gen, device="cuda").to(dta)
            x = torch.randn((B, N), generator=gen, device="cuda").to(dtx)
            w = torch.rand((B,), generator=gen, device="cuda")
            ref = mix_accumulate_ref(acc, x, w)
            out = mix_accumulate(acc, x, w)
            check(torch.equal(bits(out), bits(ref)),
                  f"mix_accumulate differs from its plain version ({dta}, {dtx}, "
                  f"({B}, {N}))")
            inplace = acc.clone()
            check(mix_accumulate(inplace, x, w, out=inplace) is inplace
                  and torch.equal(bits(inplace), bits(out)),
                  "mix_accumulate in place into acc differs")
            if dta == dtx:
                xi = x.clone()
                check(torch.equal(bits(mix_accumulate(acc, xi, w, out=xi)), bits(out)),
                      "mix_accumulate in place into x differs")
            init = mix_accumulate(None, x, w)
            check(torch.equal(bits(init), bits(mix_accumulate_ref(None, x, w))),
                  "mix_accumulate's init form differs")
            xi = x.clone()
            check(torch.equal(bits(mix_accumulate(None, xi, w, out=xi)), bits(init)),
                  "mix_accumulate's init form in place differs")
    torch.cuda.synchronize()
    print(f"kernels: quantize_block and dequantize_block on {cases} cases (levels "
          f"127 and 7, blocks 128, 64, 32, ragged N, all-zero, tie and "
          f"subnormal-scale blocks: {subnormal} subnormal scales) and a "
          f"row-strided view: q, scales, residual (in place too) and decode (into "
          f"an N-wide out too) bit for bit; gather_mix_int8 on C in 2..200, blocks "
          f"128, 64, 32, ragged N, numpy and tensor sources: max abs err {worst_g:.3e} (tol 1e-6 x max|dequant|); "
          f"mix_accumulate f32, bf16 and bf16 x into f32, in place into acc and x, "
          f"both forms: bit for bit")


def slot_loop(torch, cfg, capacity, live, seq, device, seed, draw_on=None,
              mixer_factory=None, timed_step=None, loop_cls=None, codec=None):
    """A SlotTrainLoop over ``cfg`` on ``device``: ``live`` clients of
    ``capacity`` slots, sgd(0.05), fedlay over 2 spaces with resident flat
    parameters, compressed by ``codec`` when given; parameters from
    generators on ``draw_on`` (default ``device``) seeded by node, one
    sequence of ``seq`` tokens a client and round from numpy keyed by
    (node, round)."""
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
                            codec=codec, mixer_factory=mixer_factory)
    step = dfl_local_step(cfg, sgd(0.05))
    return (loop_cls or SlotTrainLoop)(
        ctl, local_step=timed_step(step) if timed_step else step,
        make_params=make_params, optimizer=sgd(0.05), make_batch=make_batch)


def small_train(torch, codec=None):
    """tiny_lm under SlotTrainLoop on the card and on the CPU, the same
    parameters, data and churn, codec-free or compressed by ``codec``: the
    same alive sequence, and each round's loss within 1e-4 relative (f32
    on both; the card sums in other orders, over 6 rounds)."""
    from repro_torch.configs import tiny_lm
    from repro_torch.overlay.events import ChurnTrace
    runs = []
    for device in ("cpu", "cuda"):
        loop = slot_loop(torch, tiny_lm(), 8, 7, 64, device, seed=0, draw_on="cpu",
                         codec=codec)
        recs = loop.run(6, trace=ChurnTrace.scripted(TRAIN_CHURN))
        runs.append(([r.num_alive for r in recs], [r.loss for r in recs]))
    (cpu_alive, cpu_loss), (gpu_alive, gpu_loss) = runs
    check(cpu_alive == gpu_alive, f"alive sequences differ: {cpu_alive} vs {gpu_alive}")
    err = max(abs(a - b) / abs(b) for a, b in zip(gpu_loss, cpu_loss))
    check(err <= 1e-4, f"tiny_lm losses differ by {err:.3e} relative ({codec})")
    print(f"small: tiny_lm SlotTrainLoop{'' if codec is None else ' with ' + codec}, "
          f"8 slots, 6 rounds with a fail and a join: card == CPU alive sequence "
          f"{gpu_alive}, max loss difference {err:.3e} relative (tol 1e-4)")


def small_codec_rounds(torch):
    """One masked round of each codec over the same (8, 10000) buffer,
    residual, mask and edge mask on the card and on the CPU: the output
    within 1e-6 x max|buf| (the gathers sum in other orders), the
    error-feedback residual bit for bit (the same quantization, or the
    same top-k set: |x| has no ties here)."""
    import numpy as np
    from repro_torch.core.mixing import build_permute_schedule
    from repro_torch.dist.sync import global_mixer
    from repro_torch.wire.codec import WIRE_CODECS
    rng = np.random.default_rng(8)
    C, N = 8, 10000
    X = rng.normal(size=(C, N)).astype(np.float32)
    R = (rng.normal(size=(C, N)) * 0.01).astype(np.float32)
    mask = np.ones(C, np.float32)
    mask[[2, 5]] = 0.0
    em = (rng.random((C, 4)) > 0.2).astype(np.float32)
    sched = build_permute_schedule(C, 2)
    worst = {}
    for name, codec in WIRE_CODECS.items():
        outs = []
        for device in ("cpu", "cuda"):
            mixer = global_mixer("fedlay", sched, masked=True, codec=name, flat_io=True)
            buf = torch.from_numpy(X).to(device)
            ws = codec.workspace(C, N, buf.device)
            args = (buf, mask) + ((torch.from_numpy(R.copy()).to(device),)
                                  if codec.error_feedback else ())
            res = mixer(*args, edge_mask=em, workspace=ws)
            outs.append(res if codec.error_feedback else (res, None))
        (out_c, res_c), (out_g, res_g) = outs
        err = (out_g.cpu() - out_c).abs().max().item()
        check(err <= 1e-6 * float(np.abs(X).max()),
              f"the {name} round differs between card and CPU by {err}")
        if res_c is not None:
            check(torch.equal(bits(res_g.cpu()), bits(res_c)),
                  f"the {name} residual differs between card and CPU")
        worst[name] = err
    print("small: one masked round with an edge mask, (8, 10000), card vs CPU: "
          + ", ".join(f"{n} {e:.3e}" for n, e in worst.items())
          + " max abs err (tol 1e-6 x max|buf|); int8-block, int4-block and topk "
          "residual bit for bit")


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


def local_step_bytes(cfg, N: int) -> int:
    """One client's local step beyond the resident buffers, reckoned: its
    activations (act_bytes) with its gradient row filling in during the
    backward pass, or after it the gradient and the update, two rows;
    the larger."""
    return max(act_bytes(cfg, TRAIN_SEQ) + 4 * N, 2 * 4 * N)


def fit_depth(torch, base, resident_of, step_bytes=None):
    """The most layers whose reckoned bytes, ``resident_of(N)`` + the
    local step's (``step_bytes(cfg, N)``, by default local_step_bytes),
    stay within 80 % of the card's memory.  Returns (cfg, N, resident,
    reckoned, limit)."""
    limit = 0.8 * torch.cuda.get_device_properties(0).total_memory
    best = None
    for layers in range(1, base.num_layers + 1):
        cfg = dataclasses.replace(base, num_layers=layers)
        N = flat_size(torch, cfg)
        resident = resident_of(N)
        total = resident + (step_bytes or local_step_bytes)(cfg, N)
        if total > limit:
            break
        best = (cfg, N, resident, total)
    check(best is not None, "not even one layer fits the card")
    return best + (limit,)


def body_turns(torch, buf, srcs, weights, out, scale) -> dict:
    """gather_mix's register and gather bodies on the same f32 (C, N) round
    (C within the register body's rows), in turns: the plan's body, the
    other, the other, the plan's; device ms a call of each turn, by body.
    The other body's output is held to the plain version within 1e-6 x
    ``scale`` on the first and last column chunks."""
    from repro_torch.kernels.gather_mix import (_sm_count, gather_plan, launch, launch_plan,
                                                register_plan)
    from repro_torch.kernels.ref import gather_mix_ref, gather_table
    C, N = buf.shape
    table = gather_table(C, srcs, weights).to(device=buf.device, dtype=torch.int32)
    at = (buf.data_ptr(), out.data_ptr(), _sm_count(buf.device.index))
    mine = launch_plan(C, table.shape[1], N, 4, *at)
    other = (gather_plan(C, table.shape[1], N, 4, *at) if mine.body == "register"
             else register_plan(C, N, 4, *at))
    turns = {mine.body: [], other.body: []}
    for plan in (mine, other, other, mine):
        launch(buf, table, weights, out, plan)
        if plan is other and not turns[other.body]:
            for a in sorted({0, max(0, N - CHUNK)}):
                ref = gather_mix_ref(buf[:, a:a + CHUNK], table, weights)
                err = (out[:, a:a + CHUNK] - ref).abs().max().item()
                check(err <= 1e-6 * scale, f"gather_mix's {other.body} body differs from "
                                           f"the plain version by {err}")
        turns[plan.body].append(device_ms(torch, [lambda: launch(buf, table, weights, out,
                                                                 plan)], 3))
    return turns


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
    C = TRAIN_CAPACITY
    cfg, N, resident, reckoned, limit = fit_depth(torch, base, lambda n: 2 * C * n * 4)
    print(f"train: {base.name} at full width (d_model {cfg.d_model}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied) cut to "
          f"{cfg.num_layers} of {base.num_layers} layers: the most whose "
          f"reckoned bytes, {resident / 1e9:.2f} GB resident (2 x {C} x N x 4, "
          f"N = {N}) + {(reckoned - resident) / 1e9:.2f} GB for the local step, "
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
    check(peak <= reckoned * (1 + PEAK_MARGIN),
          f"peak memory {peak / 1e9:.2f} GB above the reckoned {reckoned / 1e9:.2f} GB "
          f"+ {PEAK_MARGIN:.0%}")
    print(f"train: gather_mix launches {launches} = {TRAIN_ROUNDS} rounds; dead "
          f"rows unchanged bit for bit ({dead_checked} row-rounds); joiner "
          f"{joins[0][0]} (slot {joins[0][1]}) == donor {joins[0][2]} (slot "
          f"{joins[0][3]}) bit for bit as the plan landed; 2 resident buffers "
          f"(the sgd state is empty), data_ptr unchanged over {TRAIN_ROUNDS} "
          f"rounds; peak memory {peak / 1e9:.2f} GB <= {reckoned / 1e9:.2f} GB "
          f"reckoned + {PEAK_MARGIN:.0%} ({card})")

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
    turns = body_turns(torch, inp, srcs, weights, out, scale)
    print(f"train: gather_mix's bodies at the round's shape, in turns (the plan's "
          f"first): " + "; ".join(f"{b} " + " / ".join(f"{t:.3f}" for t in ts) + " ms"
                                  for b, ts in turns.items())
          + f"; bound {bound_ms:.3f} ms ({card})")
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


# --------------------------------------------------------------------------
# The wire-compressed DFL round
# --------------------------------------------------------------------------

WIRE_CODECS_RUN = ("int8-block", "int4-block")


def wire_resident(torch, codec, C, N) -> int:
    """The wire round's resident bytes: population, mixer output (which
    also holds the error-feedback operand buf + residual until the round
    writes it) and the residual, 3 x C x N x 4, plus the codec's wire
    buffers (its workspace, sized on the meta device)."""
    ws = codec.workspace(C, N, "meta")
    return 3 * C * N * 4 + sum(t.numel() * t.element_size() for t in ws.values())


def phase_wire(torch, card, name):
    """The compressed DFL round at Llama-3.2-3B width under ``name``, with
    its checks, the codec-free losses at the same depth, and the new
    kernels' times at the round's shape.  Returns the kernels' entries
    (by name) and the losses."""
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.dist import sync
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gather_mix import gather_mix
    from repro_torch.kernels.mix_accumulate import mix_accumulate
    from repro_torch.kernels.ref import (dequantize_block_ref, gather_mix_int8_ref,
                                         mix_accumulate_ref, quantize_block_ref,
                                         round_matrix)
    from repro_torch.kernels.wire_codec import (dequantize_block, gather_mix_int8,
                                                quantize_block)
    from repro_torch.overlay.events import ChurnTrace
    from repro_torch.overlay.runtime import joiner_donors
    from repro_torch.runtime.loop import SlotTrainLoop
    from repro_torch.runtime.slots import plan_reset_slots
    from repro_torch.wire import codec as codec_mod
    from repro_torch.wire.codec import get_codec

    codec = get_codec(name)
    block, levels, C = codec.block, codec.levels, TRAIN_CAPACITY
    base = REGISTRY["llama3.2-3b"]
    cfg, N, resident, reckoned, limit = fit_depth(
        torch, base, lambda n: wire_resident(torch, codec, C, n))
    print(f"wire: {name} round at full width cut to {cfg.num_layers} of "
          f"{base.num_layers} layers: the most whose reckoned bytes, "
          f"{resident / 1e9:.2f} GB resident (population, mixer output and "
          f"residual, 3 x {C} x N x 4, N = {N}, and the wire, "
          f"{(resident - 12 * C * N) / 1e9:.2f} GB) + "
          f"{(reckoned - resident) / 1e9:.2f} GB for the local step, stay within "
          f"80 % of the card's {limit / 0.8 / 1e9:.2f} GB")
    # the codec-free round at the same depth, from the same population and
    # batches, for its losses
    gc.collect()
    torch.cuda.empty_cache()
    loop = slot_loop(torch, cfg, C, TRAIN_LIVE, TRAIN_SEQ, "cuda", seed=1000)
    free_losses = [r.loss for r in loop.run(TRAIN_ROUNDS, trace=ChurnTrace.scripted(
        TRAIN_CHURN))]
    del loop

    kernels = (quantize_block, dequantize_block, gather_mix_int8, mix_accumulate,
               gather_mix, flash_decode)
    times = {"local": [], "mix": []}
    seen = {"joins": [], "resets": 0, "kept": 0, "dead": 0}
    last = {}

    def timed_step(fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times["local"].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def mixer_factory(sched):
        mixer = sync.global_mixer("fedlay", sched, masked=True, codec=name, flat_io=True)

        def run(buf, mask, residual, **kw):
            masked = np.flatnonzero(np.asarray(mask) == 0).tolist()
            kept = {r: residual[r].to("cpu", copy=True) for r in masked}
            if last.get("snapshot"):
                last["res_in"] = residual.to("cpu", copy=True)
            last["mask"] = np.asarray(mask).copy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = mixer(buf, mask, residual, **kw)
            torch.cuda.synchronize()
            times["mix"].append((time.perf_counter() - t0) * 1e3)
            for r, row in kept.items():
                check(torch.equal(bits(residual[r].cpu()), bits(row)),
                      f"the residual of masked row {r} changed")
                seen["kept"] += 1
            return out
        return run

    class CheckedLoop(SlotTrainLoop):
        """Holds each joiner's row to its donor's and the reset residual
        rows to zero as the plan lands."""

        def _apply_plan(self, plan):
            joined, left = super()._apply_plan(plan)
            ctl = self.controller
            donors = joiner_donors(ctl.alive_schedule, ctl.alive, joined,
                                   tuple(u for u, _ in plan.survivors))
            for u in joined:
                a, b = ctl.slots.slot_of[u], ctl.slots.slot_of[donors[u]]
                check(torch.equal(self.params[a], self.params[b]),
                      f"joiner {u}'s row differs from donor {donors[u]}'s")
                seen["joins"].append((u, a, donors[u], b))
            for slot in plan_reset_slots(plan):
                check(not bool(self.residual[slot].any()),
                      f"the residual row of slot {slot} was not reset")
                seen["resets"] += 1
            return joined, left

    # record the neighbour table and the self weights as they reach the kernels
    real = {"int8": codec_mod.gather_mix_int8, "gm": codec_mod.gather_mix,
            "acc": sync.mix_accumulate}

    def rec_int8(q, s, srcs, weights, **kw):
        last.update(srcs=srcs, weights=weights)
        return real["int8"](q, s, srcs, weights, **kw)

    def rec_gm(buf, srcs, weights, **kw):
        last.update(srcs=srcs, weights=weights)
        return real["gm"](buf, srcs, weights, **kw)

    def rec_acc(acc, x, w, **kw):
        last["self_w"] = w
        return real["acc"](acc, x, w, **kw)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop = slot_loop(torch, cfg, C, TRAIN_LIVE, TRAIN_SEQ, "cuda", seed=1000,
                     codec=name, mixer_factory=mixer_factory, timed_step=timed_step,
                     loop_cls=CheckedLoop)
    torch.cuda.synchronize()
    print(f"wire: {name}: population ({C}, {N}) f32 and its residual, "
          f"{TRAIN_LIVE} clients drawn in {time.perf_counter() - t0:.1f} s")
    ws = loop.workspace
    ptrs = ({loop.params.data_ptr(), loop._spare.data_ptr()},
            {k: t.data_ptr() for k, t in ws.items()}, loop.residual.data_ptr())
    trace = ChurnTrace.scripted(TRAIN_CHURN)
    ctl = loop.controller
    counts = []
    codec_mod.gather_mix_int8, codec_mod.gather_mix = rec_int8, rec_gm
    sync.mix_accumulate = rec_acc
    try:
        for k in kernels:
            k.launches = 0
        for r in range(TRAIN_ROUNDS):
            last["snapshot"] = r == TRAIN_ROUNDS - 1
            before = {s: loop.params[s].to("cpu", copy=True) for s in range(C)
                      if ctl.slots.node_at(s) is None
                      or ctl.slots.node_at(s) in {e[2] for e in TRAIN_CHURN}}
            start = [k.launches for k in kernels]
            rec = loop.run(1, trace=trace)[-1]
            counts.append([k.launches - a for k, a in zip(kernels, start)])
            for s, row in before.items():
                if ctl.slots.node_at(s) is None:
                    check(torch.equal(loop.params[s].cpu(), row),
                          f"dead slot {s} changed in round {r}")
                    seen["dead"] += 1
            print(f"wire: {name} round {r}: {rec.num_alive} alive (joined "
                  f"{list(rec.joined)}, left {list(rec.left)}), loss {rec.loss:.6f}; "
                  f"local step {times['local'][-1]:.1f} ms, mixing "
                  f"{times['mix'][-1]:.2f} ms")
            check(np.isfinite(rec.loss), f"round {r} loss is not finite")
        launches = {k.__name__: k.launches for k in kernels}
    finally:
        codec_mod.gather_mix_int8, codec_mod.gather_mix = real["int8"], real["gm"]
        sync.mix_accumulate = real["acc"]
    peak = torch.cuda.max_memory_allocated()
    losses = [r.loss for r in loop.records]
    want = ([1, 0, 1, 1, 0, 0] if name == "int8-block" else [1, 1, 0, 1, 1, 0])
    for r, got in enumerate(counts):
        check(got == want, f"round {r} launched {dict(zip((k.__name__ for k in kernels), got))}")
    check([r.num_alive for r in loop.records] == [7, 6, 6, 7, 7, 7],
          f"alive sequence {[r.num_alive for r in loop.records]}")
    check(len(seen["joins"]) == 1 and seen["dead"] > 0 and seen["resets"] >= 2
          and seen["kept"] > 0, f"churn checks did not all run: {seen}")
    check(({loop.params.data_ptr(), loop._spare.data_ptr()},
           {k: t.data_ptr() for k, t in ws.items()}, loop.residual.data_ptr()) == ptrs,
          "a resident buffer was reallocated")
    check(peak <= reckoned * (1 + PEAK_MARGIN),
          f"peak memory {peak / 1e9:.2f} GB above the reckoned {reckoned / 1e9:.2f} GB "
          f"+ {PEAK_MARGIN:.0%}")
    per_round = ", ".join(f"{k.__name__} {n}" for k, n in zip(kernels, want) if n)
    j = seen["joins"][0]
    print(f"wire: {name} launches a round: {per_round} in each of {TRAIN_ROUNDS} rounds "
          f"(the others 0); dead rows unchanged bit for bit ({seen['dead']} row-rounds); "
          f"joiner {j[0]} (slot {j[1]}) == donor {j[2]} (slot {j[3]}) bit for bit and "
          f"{seen['resets']} residual rows of joiners and leavers zero as each plan "
          f"landed; masked rows' residual unchanged ({seen['kept']} row-rounds); "
          f"{2 + len(ws) + 1} resident buffers (population, spare, residual, "
          f"{', '.join(ws)}) kept their data_ptr; peak memory {peak / 1e9:.2f} GB <= "
          f"{reckoned / 1e9:.2f} GB reckoned + {PEAK_MARGIN:.0%} ({card})")

    # the last round against the plain path, column chunk by chunk
    out, inp, res_out = loop.params, loop._spare, loop.residual
    res_in, mask = last["res_in"], last["mask"]
    srcs, weights, self_w = last["srcs"], last["weights"], last["self_w"]
    live = torch.as_tensor(mask > 0, device="cuda")
    err = scale = err_q = err_g = err_a = 0.0
    for a in range(0, N, CHUNK):
        b = min(a + CHUNK, N)
        x = inp[:, a:b]
        rin = res_in[:, a:b].to("cuda")
        qr, sr, rr = quantize_block_ref(x + rin, block, levels, True)
        qk = ws["q"][:, a:a + qr.shape[1]]
        sk = ws["scales"][:, a // block:a // block + sr.shape[1]]
        q_bad = int((qk != qr).sum())
        s_bad = int((bits(sk) != bits(sr)).sum())
        check(q_bad == 0 and s_bad == 0,
              f"{q_bad} q and {s_bad} scales differ from the plain version in "
              f"columns {a}..{b}")
        want_res = torch.where(live[:, None], rr, rin)
        check(torch.equal(bits(res_out[:, a:b]), bits(want_res)),
              f"the residual differs from the plain version in columns {a}..{b}")
        err_q = max(err_q, (res_out[:, a:b] - want_res).abs().max().item(),
                    (dequantize_block_ref(qk, sk, block)
                     - dequantize_block_ref(qr, sr, block)).abs().max().item())
        g = gather_mix_int8_ref(qr, sr, srcs, weights, block)
        ref = torch.where(live[:, None], mix_accumulate_ref(g, x, self_w), x)
        err = max(err, (out[:, a:b] - ref).abs().max().item())
        scale = max(scale, x.abs().max().item())
        if name == "int8-block":
            got = gather_mix_int8(qr, sr, srcs, weights, block=block)
            err_g = max(err_g, (got - g).abs().max().item())
            acc = mix_accumulate(got, x.contiguous(), self_w)
            err_a = max(err_a, (acc - mix_accumulate_ref(got, x, self_w)).abs().max().item())
        else:
            err_g = max(err_g, (dequantize_block(qr, sr, block=block)
                                - dequantize_block_ref(qr, sr, block)).abs().max().item())
        del rin, qr, sr, rr, want_res, g, ref
    del res_in
    check(err <= 1e-6 * scale, f"the {name} round differs from the plain path by {err}")
    print(f"wire: {name} round {TRAIN_ROUNDS - 1} against the plain path over column "
          f"chunks of {CHUNK}: output max abs err {err:.3e} <= 1e-6 x max|buf| "
          f"{scale:.3f}; q, scales and residual bit for bit")

    # where a round's time goes, against the codec-free round on the same buffers
    steady = range(3, TRAIN_ROUNDS)
    local = sum(times["local"][i] for i in steady) / len(steady)
    mix = sum(times["mix"][i] for i in steady) / len(steady)
    residual = loop.residual
    mixer = sync.global_mixer("fedlay", ctl.schedule, masked=True, codec=name,
                              flat_io=True)
    free = sync.global_mixer("fedlay", ctl.schedule, masked=True, fuse="flat",
                             flat_io=True)
    free_ms = host_ms(torch, lambda: free(inp, mask, out=out), 5)
    print(f"breakdown: {name} DFL round at {cfg.num_layers} layer(s), {TRAIN_LIVE} "
          f"live: over rounds 3-{TRAIN_ROUNDS - 1} local step {local:.1f} ms and mixing "
          f"{mix:.2f} ms a round; the codec-free gather_mix round on the same buffers "
          f"{free_ms:.2f} ms ({card})")
    wall, by_kernel = profiled(torch, lambda: mixer(inp, mask, residual, out=out,
                                                    workspace=ws))
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(f"breakdown: {name} mixing round profiled: host {wall:.2f} ms, device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f} %), idle share "
          f"{100 * (1 - busy / wall):.1f} %; kernels (ms): "
          + "; ".join(f"{k[:40]} {ms:.3f}" for k, ms in top) + f" ({card})")

    # each new kernel at the round's own shape (the loop's buffers are
    # free for reuse from here on)
    entries = {}
    NB = ws["scales"].shape[1]
    Nq = NB * block
    q, s = ws["q"], ws["scales"]

    def bound(nbytes, ops):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
        return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")

    def chunked(fn):
        def run():
            for a in range(0, N, CHUNK):
                fn(a, min(a + CHUNK, N))
        return run

    def entry(kname, err_k, ms, plain_ms, lib_ms, nbytes, ops, replaces, what):
        bound_ms, bound_by = bound(nbytes, ops)
        print(f"wire: {kname} f32 at the round's shape C = {C}, N = {N}: device time "
              f"per call: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (over column "
              f"chunks of {CHUNK}), bound {bound_ms:.3f} ms ({bound_by}), library "
              + ("none" if lib_ms is None else f"{lib_ms:.3f} ms ({what})")
              + f"; max abs err {err_k:.3e} ({card})")
        entries[kname] = {
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kname}.cu", "replaces": replaces,
            "launches": launches[kname], "max_abs_err": err_k, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}

    if name == "int8-block":
        ms = device_ms(torch, [lambda: quantize_block(
            inp, block=block, levels=levels, with_residual=True, q_out=q,
            scales_out=s, residual_out=residual)], 5)
        plain = device_ms(torch, [chunked(lambda a, b: quantize_block_ref(
            inp[:, a:b], block, levels, True))], 1)
        entry("quantize_block", err_q, ms, plain, None, (4 + 4) * C * N + C * Nq + 2 * C * NB,
              0, "src/repro/kernels/wire_codec.py:95", None)
        W = round_matrix(C, srcs, weights)
        ms = device_ms(torch, [lambda: gather_mix_int8(q, s, srcs, weights, block=block,
                                                       out=out)], 5)
        plain = device_ms(torch, [chunked(lambda a, b: gather_mix_int8_ref(
            q[:, a:b], s[:, a // block:b // block], srcs, weights, block))], 1)
        deq3 = out.view(C, NB, block)

        def library():
            torch.mul(q.view(C, NB, block), s.float()[..., None], out=deq3)
            torch.matmul(W, out, out=residual)
        lib = device_ms(torch, [library], 3)
        entry("gather_mix_int8", err_g, ms, plain, lib, C * Nq + 2 * C * NB + 4 * C * N,
              2 * C * C * N, "src/repro/kernels/wire_codec.py:233",
              "a dequantize by torch.mul, then torch.matmul(W, ·)")
        sw = self_w.float().contiguous()
        ms = device_ms(torch, [lambda: mix_accumulate(out, inp, sw, out=out)], 5)
        plain = device_ms(torch, [chunked(lambda a, b: mix_accumulate_ref(
            out[:, a:b], inp[:, a:b], sw))], 1)
        lib = device_ms(torch, [lambda: torch.addcmul(out, inp, sw[:, None], out=out)], 5)
        entry("mix_accumulate", err_a, ms, plain, lib, 12 * C * N + 4 * C, 2 * C * N,
              "src/repro/kernels/weighted_mix.py:150", "torch.addcmul")
    else:
        ms = device_ms(torch, [lambda: dequantize_block(q, s, block=block, out=out)], 5)
        plain = device_ms(torch, [chunked(lambda a, b: dequantize_block_ref(
            q[:, a:b], s[:, a // block:b // block], block))], 1)
        deq3 = out.view(C, NB, block)
        lib = device_ms(torch, [lambda: torch.mul(q.view(C, NB, block),
                                                  s.float()[..., None], out=deq3)], 5)
        entry("dequantize_block", err_g, ms, plain, lib, C * Nq + 2 * C * NB + 4 * C * Nq,
              C * Nq, "src/repro/kernels/wire_codec.py:145", "torch.mul")
    uniform = float(np.log(cfg.vocab_size))
    print(f"wire: losses at {cfg.num_layers} layer(s), {name} against codec-free, "
          f"round by round (ln vocab = {uniform:.4f}): " + "; ".join(
              f"{a:.6f} / {b:.6f}" for a, b in zip(losses, free_losses)))
    return entries, losses, free_losses


def check_dequant_accumulate(torch):
    """dequant_accumulate against its plain version on the card, bit for
    bit: f32 and bf16 acc of N <= Nq columns (ragged and whole), blocks
    128, 64 and 32, in place into acc, an acc off the 16-byte grid, the
    init form, B from 1 to 65535, and the sum whose float64 rounding lands
    on an f32 midpoint (the kernel's fmaf and the plain version both
    round it once)."""
    from repro_torch.kernels.ref import dequant_accumulate_ref
    from repro_torch.kernels.wire_codec import dequant_accumulate, quantize_block
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = 0
    for block in (128, 64, 32):
        for B, N in [(1, 1), (3, 1000), (4, 4133), (8, 4096), (5, 3 * 128 * 64 + 1),
                     (3000, 256), (65535, 32)]:
            q, s = quantize_block(wire_rows(torch, gen, B, N, block, 127), block=block)
            w = torch.rand((B,), generator=gen, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                acc = torch.randn((B, N), generator=gen, device="cuda").to(dtype)
                ref = dequant_accumulate_ref(acc, q, s, w, block)
                out = dequant_accumulate(acc, q, s, w, block=block)
                check(out.dtype == dtype and torch.equal(bits(out), bits(ref)),
                      f"dequant_accumulate differs at block {block}, ({B}, {N}), {dtype}")
                a = acc.clone()
                check(dequant_accumulate(a, q, s, w, block=block, out=a) is a
                      and torch.equal(bits(a), bits(ref)),
                      "dequant_accumulate in place into acc differs")
                off = torch.empty(B * N + 1, dtype=dtype, device="cuda")[1:].view(B, N)
                off.copy_(acc)
                check(torch.equal(bits(dequant_accumulate(off, q, s, w, block=block)),
                                  bits(ref)), "dequant_accumulate off the 16-byte grid differs")
            init = dequant_accumulate(None, q, s, w, block=block)
            check(init.shape == q.shape and torch.equal(
                bits(init), bits(dequant_accumulate_ref(None, q, s, w, block))),
                "dequant_accumulate's init form differs")
            cases += 1
    q = torch.zeros((1, 128), dtype=torch.int8, device="cuda")
    q[0, 0] = 65
    s = torch.full((1, 1), 149 * 2.0 ** -7, device="cuda").bfloat16()
    w = torch.tensor([14190909 * 2.0 ** -23], device="cuda")
    acc = torch.full((1, 128), 2.0 ** 31, device="cuda")
    tie = dequant_accumulate(acc, q, s, w)[0, 0].item()
    check(tie == dequant_accumulate_ref(acc, q, s, w)[0, 0].item() == 2.0 ** 31 + 256,
          f"dequant_accumulate rounds the midpoint case to {tie}")
    torch.cuda.synchronize()
    print(f"kernels: dequant_accumulate on {cases} shapes (blocks 128, 64, 32, B 1 to "
          f"65535, ragged N), f32 and bf16 acc, in place, off the 16-byte grid, and the "
          f"init form: bit for bit; the float64-midpoint sum rounds once to 2^31 + 256")


def small_mesh_rounds(torch, mesh):
    """One per-rank fedlay round of each codec at tiny_lm width: 8 clients
    on the one-rank NCCL group (every edge an intra-rank take) on the card
    against the same round on the CPU: the output within 1e-6 x max|buf|
    (its error is printed), the residual bit for bit (the same
    quantization, or the same top-k set)."""
    import numpy as np
    from repro_torch.configs import tiny_lm
    from repro_torch.core.mixing import build_permute_schedule
    from repro_torch.dist.flat import FlatSpec, tree_flatten, tree_map
    from repro_torch.dist.sync import make_mixer
    from repro_torch.models.model import init_params
    from repro_torch.wire.codec import WIRE_CODECS
    C = 8
    tree = tree_map(lambda *ls: torch.stack(ls), *[
        init_params(tiny_lm(), torch.Generator().manual_seed(c)) for c in range(C)])
    N = FlatSpec.for_tree(tree).size
    R = (np.random.default_rng(9).normal(size=(C, N)) * 0.01).astype(np.float32)
    sched = build_permute_schedule(C, 2)
    scale = max(l.abs().max().item() for l in tree_flatten(tree)[0])
    worst = {}
    for name, codec in WIRE_CODECS.items():
        outs = []
        for device in ("cpu", "cuda"):
            t = tree_map(lambda l: l.to(device), tree)
            mixer = make_mixer("fedlay", sched, mesh.group, C, clients_per_device=C,
                               codec=name)
            args = (t, sched.weights, sched.self_weight)
            if codec.error_feedback:
                outs.append(mixer(*args, torch.from_numpy(R.copy()).to(device)))
            else:
                outs.append((mixer(*args), None))
        (out_c, res_c), (out_g, res_g) = outs
        err = max((a.cpu() - b).abs().max().item() for a, b in
                  zip(tree_flatten(out_g)[0], tree_flatten(out_c)[0]))
        check(err <= 1e-6 * scale, f"the per-rank {name} round differs between card "
              f"and CPU by {err}")
        if res_c is not None:
            check(torch.equal(bits(res_g.cpu()), bits(res_c)),
                  f"the per-rank {name} residual differs between card and CPU")
        worst[name] = err
    print(f"small: one per-rank fedlay round at tiny_lm width, 8 clients on the "
          f"one-rank NCCL group, N = {N}, card vs CPU: "
          + ", ".join(f"{n} {e:.3e}" for n, e in worst.items())
          + " max abs err (tol 1e-6 x max|buf|); int8-block, int4-block and topk "
          "residual bit for bit")


# --------------------------------------------------------------------------
# The per-rank mixer over a process group
# --------------------------------------------------------------------------

MESH_ROUNDS = 3
MESH_CODEC = "int8-block"


def mesh_resident(torch, codec, C, N) -> int:
    """The per-rank round's resident bytes: population, mixer output
    (which holds the error-feedback operand buf + residual until the self
    term is written) and the residual, 3 x C x N x 4, and the wire twice:
    the rank's encoded rows (the codec's workspace) and one slot's
    received rows, which the mixer allocates for its call."""
    ws = codec.workspace(C, N, "meta")
    return 3 * C * N * 4 + 2 * sum(t.numel() * t.element_size() for t in ws.values())


class MeshLoop:
    """C clients of ``cfg`` on the rank of a one-rank group: one resident
    (C, N) population buffer whose row views the local step
    (dfl_local_step, sgd 0.05, one sequence of TRAIN_SEQ tokens a client
    and round, as in the wire phase) updates in place, mixed by the
    controller's per-rank mixer into the second buffer (the two swap roles
    each round), compressed by ``codec`` with its residual, over NDMP with
    L = 2 spaces.  Parameters are drawn from generators seeded by client."""

    def __init__(self, torch, cfg, mesh, codec, seed):
        import numpy as np
        from repro_torch.core.ndmp import Simulator
        from repro_torch.dist.flat import FlatSpec, tree_map
        from repro_torch.launch.steps import dfl_local_step
        from repro_torch.models.model import init_params
        from repro_torch.optim.optimizers import sgd
        from repro_torch.overlay.controller import OverlayController
        self.torch, self.np, self.cfg = torch, np, cfg
        C = self.C = TRAIN_CAPACITY
        sim = Simulator(num_spaces=2, latency=0.05, heartbeat_period=0.5,
                        probe_period=1.0, seed=0)
        sim.seed_network(list(range(C)))
        self.ctl = OverlayController(sim, mixer_kind="shard_map", group=mesh.group,
                                     clients_per_device=C, fuse="flat", codec=codec)
        shapes = init_params(cfg, torch.Generator(), device="meta")
        self.spec = FlatSpec.for_tree(tree_map(
            lambda l: l.unsqueeze(0).expand((C,) + tuple(l.shape)), shapes))
        row_spec = FlatSpec.for_tree(tree_map(lambda l: l.unsqueeze(0), shapes))
        self.pop = torch.zeros((C, self.spec.size), device="cuda")
        for c in range(C):
            gen = torch.Generator(device="cuda").manual_seed(seed + c)
            row_spec.ravel(tree_map(lambda l: l.unsqueeze(0), init_params(cfg, gen)),
                           out=self.pop[c:c + 1])
        self.spare = torch.empty_like(self.pop)
        codec = self.ctl.codec
        self.ef = codec is not None and codec.error_feedback
        self.residual = torch.zeros_like(self.pop) if self.ef else None
        self.ws = codec.workspace(C, self.spec.size, "cuda") if codec is not None else {}
        self.step = dfl_local_step(cfg, sgd(0.05))
        self.rounds = 0

    def buffers(self):
        return ({self.pop.data_ptr(), self.spare.data_ptr()},
                None if self.residual is None else self.residual.data_ptr(),
                {k: t.data_ptr() for k, t in self.ws.items()})

    def mix(self):
        """The live mixer's round: self.pop in, self.spare out."""
        sched = self.ctl.schedule
        args = (self.spec.unravel(self.pop), sched.weights, sched.self_weight)
        kw = {"buf": self.pop, "out": self.spare}
        if self.ws:
            kw["workspace"] = self.ws
        return self.ctl.mixer(*args, *((self.residual,) if self.ef else ()), **kw)

    def round(self, before_mix=None):
        """One DFL round; returns (loss, local step ms, mixing ms)."""
        torch, np = self.torch, self.np
        self.ctl.step(1.0)
        self.ctl.commit()
        toks = np.stack([np.random.default_rng([u, self.rounds]).integers(
            0, self.cfg.vocab_size, (1, TRAIN_SEQ + 1)) for u in range(self.C)])
        t = torch.from_numpy(toks).to("cuda")
        batch = {"tokens": t[..., :-1], "labels": t[..., 1:]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, metrics = self.step(self.spec.unravel(self.pop), (), batch,
                                  np.ones(self.C, np.float32))
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if before_mix is not None:
            before_mix(self)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        self.mix()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        self.pop, self.spare = self.spare, self.pop
        self.rounds += 1
        return loss, (t1 - t0) * 1e3, (t3 - t2) * 1e3


def phase_mesh(torch, card, mesh):
    """The per-rank int8-block DFL round at Llama-3.2-3B width on a one-rank
    NCCL group, with its checks, the codec-free per-rank round's losses at
    the same depth, and dequant_accumulate at the round's shape."""
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.dist.sync import global_mixer
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gather_mix import gather_mix
    from repro_torch.kernels.mix_accumulate import mix_accumulate
    from repro_torch.kernels.ref import dequant_accumulate_ref
    from repro_torch.kernels.wire_codec import (dequant_accumulate, dequantize_block,
                                                gather_mix_int8, quantize_block)
    from repro_torch.wire.codec import get_codec

    codec = get_codec(MESH_CODEC)
    C, block, base = TRAIN_CAPACITY, codec.block, REGISTRY["llama3.2-3b"]
    cfg, N, resident, reckoned, limit = fit_depth(
        torch, base, lambda n: mesh_resident(torch, codec, C, n))
    print(f"mesh: per-rank {MESH_CODEC} round, one NCCL rank holding all {C} clients "
          f"(G = {C}, every edge an intra-rank take), at full width cut to "
          f"{cfg.num_layers} of {base.num_layers} layers: the most whose reckoned "
          f"bytes, {resident / 1e9:.2f} GB resident (population, mixer output and "
          f"residual, 3 x {C} x N x 4, N = {N}, and the wire twice, sent and received, "
          f"{(resident - 12 * C * N) / 1e9:.2f} GB) + {(reckoned - resident) / 1e9:.2f} "
          f"GB for the local step, stay within 80 % of the card's "
          f"{limit / 0.8 / 1e9:.2f} GB")

    # the codec-free per-rank round at the same depth: its losses, and its
    # last round against gather_mix on the same population
    gc.collect()
    torch.cuda.empty_cache()
    free = MeshLoop(torch, cfg, mesh, None, seed=1000)
    free_runs = [free.round() for _ in range(MESH_ROUNDS)]
    out, inp = free.pop, free.spare
    gm_out = torch.empty_like(inp)
    gather_mix.launches = 0
    global_mixer("fedlay", free.ctl.schedule, fuse="flat", flat_io=True)(inp, out=gm_out)
    check(gather_mix.launches == 1, "the codec-free global round did not run gather_mix")
    err_free = max((out[:, a:a + CHUNK] - gm_out[:, a:a + CHUNK]).abs().max().item()
                   for a in range(0, N, CHUNK))
    scale = max(inp[:, a:a + CHUNK].abs().max().item() for a in range(0, N, CHUNK))
    check(err_free <= 1e-6 * scale, f"the codec-free per-rank round differs from "
          f"gather_mix by {err_free}")
    print(f"mesh: codec-free per-rank round {MESH_ROUNDS - 1} against gather_mix "
          f"(global_mixer, one launch) on the same population: max abs err "
          f"{err_free:.3e} <= 1e-6 x max|buf| {scale:.3f}")
    del free, out, inp, gm_out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop = MeshLoop(torch, cfg, mesh, MESH_CODEC, seed=1000)
    torch.cuda.synchronize()
    print(f"mesh: population ({C}, {N}) f32 and its residual, {C} clients drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    ptrs = loop.buffers()
    kernels = (dequant_accumulate, quantize_block, mix_accumulate, gather_mix_int8,
               gather_mix, dequantize_block, flash_decode)
    want = [2 * 2, 1, 1, 0, 0, 0, 0]             # 2L slots a round, L = 2
    snap = {}

    def keep_residual(lp):
        snap["res_in"] = lp.residual.to("cpu", copy=True)

    for k in kernels:
        k.launches = 0
    runs = []
    for r in range(MESH_ROUNDS):
        start = [k.launches for k in kernels]
        loss, local_ms, mix_ms = loop.round(
            keep_residual if r == MESH_ROUNDS - 1 else None)
        got = [k.launches - a for k, a in zip(kernels, start)]
        check(got == want, f"round {r} launched "
              f"{dict(zip((k.__name__ for k in kernels), got))}")
        check(np.isfinite(loss), f"round {r} loss is not finite")
        runs.append((loss, local_ms, mix_ms))
        print(f"mesh: {MESH_CODEC} round {r}: loss {loss:.6f}; local step "
              f"{local_ms:.1f} ms, mixing {mix_ms:.2f} ms")
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    check(loop.buffers() == ptrs, "a resident buffer was reallocated")
    check(peak <= reckoned * (1 + PEAK_MARGIN),
          f"peak memory {peak / 1e9:.2f} GB above the reckoned {reckoned / 1e9:.2f} GB "
          f"+ {PEAK_MARGIN:.0%}")
    print(f"mesh: launches a round: dequant_accumulate 4 (2L slots), quantize_block 1, "
          f"mix_accumulate 1 (the self term), the global kernels 0, in each of "
          f"{MESH_ROUNDS} rounds; 3 resident buffers and the wire kept their data_ptr; "
          f"peak memory {peak / 1e9:.2f} GB <= {reckoned / 1e9:.2f} GB reckoned + "
          f"{PEAK_MARGIN:.0%} ({card})")

    # the last round against the global int8-block round on the same
    # population and residual
    sched = loop.ctl.schedule
    out, inp, res = loop.pop, loop.spare, loop.residual
    res_rank = res.to("cpu", copy=True)
    res.copy_(snap.pop("res_in"))
    g_out = torch.empty_like(inp)
    gather_mix_int8.launches = 0
    global_mixer("fedlay", sched, codec=MESH_CODEC, flat_io=True)(
        inp, res, out=g_out, workspace=loop.ws)
    check(gather_mix_int8.launches == 1, "the global round did not run gather_mix_int8")
    err = 0.0
    for a in range(0, N, CHUNK):
        b = min(a + CHUNK, N)
        check(torch.equal(bits(res[:, a:b]), bits(res_rank[:, a:b].to("cuda"))),
              f"the residual differs from the global round's in columns {a}..{b}")
        err = max(err, (out[:, a:b] - g_out[:, a:b]).abs().max().item())
    scale = max(inp[:, a:a + CHUNK].abs().max().item() for a in range(0, N, CHUNK))
    check(err <= 1e-6 * scale, f"the per-rank round differs from the global round by {err}")
    print(f"mesh: {MESH_CODEC} round {MESH_ROUNDS - 1} against the global {MESH_CODEC} "
          f"round (gather_mix_int8, one launch) on the same population and residual: "
          f"residual bit for bit; output max abs err {err:.3e} <= 1e-6 x max|buf| "
          f"{scale:.3f}")
    del res_rank, g_out

    # where a round's time goes
    steady = range(1, MESH_ROUNDS)
    local = sum(runs[i][1] for i in steady) / len(steady)
    mix = sum(runs[i][2] for i in steady) / len(steady)
    free_mix = sum(free_runs[i][2] for i in steady) / len(steady)
    print(f"breakdown: per-rank {MESH_CODEC} DFL round at {cfg.num_layers} layer(s), "
          f"{C} clients: over rounds 1-{MESH_ROUNDS - 1} local step {local:.1f} ms and "
          f"mixing {mix:.2f} ms a round; the codec-free per-rank round's mixing "
          f"{free_mix:.2f} ms ({card})")
    wall, by_kernel = profiled(torch, loop.mix)
    busy = sum(by_kernel.values())
    span = device_ms(torch, [loop.mix], 1)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(f"breakdown: per-rank {MESH_CODEC} mixing round profiled: host {wall:.2f} ms, "
          f"device busy {busy:.2f} ms ({100 * busy / wall:.1f} %), idle share "
          f"{100 * (1 - busy / wall):.1f} %; the round's device span (CUDA events, "
          f"queued ahead) {span:.2f} ms; kernels (ms): "
          + "; ".join(f"{k[:40]} {ms:.3f}" for k, ms in top) + f" ({card})")

    # dequant_accumulate at the round's shape: a slot's fold of the (C, Nq)
    # received rows into the (C, N) accumulator
    q, s = loop.ws["q"], loop.ws["scales"]
    NB, Nq = s.shape[1], q.shape[1]
    acc, scratch = loop.spare, loop.residual
    w = torch.as_tensor(sched.weights[:, 0], device="cuda").contiguous()
    dequant_accumulate(acc, q, s, w, block=block, out=scratch)
    err_k = 0.0
    for a in range(0, N, CHUNK):
        b = min(a + CHUNK, N)
        ref = dequant_accumulate_ref(acc[:, a:b], q[:, a:b],
                                     s[:, a // block:-(-b // block)], w, block)
        check(torch.equal(bits(scratch[:, a:b]), bits(ref)),
              f"dequant_accumulate differs from its plain version in columns {a}..{b}")
        err_k = max(err_k, (scratch[:, a:b] - ref).abs().max().item())
        del ref
    ms = device_ms(torch, [lambda: dequant_accumulate(acc, q, s, w, block=block,
                                                      out=acc)], 5)

    def plain():
        for a in range(0, N, CHUNK):
            b = min(a + CHUNK, N)
            dequant_accumulate_ref(acc[:, a:b], q[:, a:b],
                                   s[:, a // block:-(-b // block)], w, block)
    plain_ms = device_ms(torch, [plain], 1)
    deq3, w2 = scratch.view(C, NB, block), w[:, None]

    def library():
        torch.mul(q.view(C, NB, block), s.float()[..., None], out=deq3)
        acc.addcmul_(scratch, w2)
    lib_ms = device_ms(torch, [library], 5)
    nbytes, ops = C * (8 * N + Nq + 2 * NB) + 4 * C, 3 * C * N
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    bound_ms, bound_by = max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")
    print(f"mesh: dequant_accumulate f32 at the round's shape C = {C}, N = {N} (a "
          f"slot's fold, in place): bit for bit with its plain version; device time "
          f"per call: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (over column chunks "
          f"of {CHUNK}), bound {bound_ms:.3f} ms ({bound_by}, {nbytes / 1e9:.2f} GB), "
          f"library {lib_ms:.3f} ms (torch.mul of q and the scales, then "
          f"addcmul_) ({card})")
    uniform = float(np.log(cfg.vocab_size))
    print(f"mesh: losses at {cfg.num_layers} layer(s), per-rank {MESH_CODEC} against "
          f"the codec-free per-rank round, round by round (ln vocab = {uniform:.4f}): "
          + "; ".join(f"{a[0]:.6f} / {b[0]:.6f}" for a, b in zip(runs, free_runs)))
    return {"name": "dequant_accumulate", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dequant_accumulate.cu",
            "replaces": "src/repro/kernels/wire_codec.py:176",
            "launches": launches["dequant_accumulate"], "max_abs_err": err_k, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


# --------------------------------------------------------------------------
# The training front door
# --------------------------------------------------------------------------

FRONT_CLIENTS, FRONT_SPACES, FRONT_STEPS, FRONT_LR = 4, 2, 3, 3e-3
FRONT_CODEC = "int8-block"
#: the CLI at tiny_lm's defaults: clients (all on the one rank), steps,
#: checkpoint period, and the step the in-process run stops at
FRONT_CLI = dict(clients=8, steps=20, every=5, stop=10)
#: the in-process CPU run's losses against the card's, relative: f32 on
#: both, sums in other orders, over 20 AdamW steps (as small_train holds)
FRONT_CPU_TOL = 1e-4


def front_resident(torch, codec, G, N) -> int:
    """The front door's resident bytes at G clients: the parameters,
    AdamW's mu and nu and the mixer's output buffer, 4 x G x N x 4, and
    one slot's received rows, which the mixer allocates for its call:
    codec-free the f32 rows, G x N x 4; under a codec their wire image,
    beside the rank's own (the codec's workspace), and the error-feedback
    residual, G x N x 4."""
    if codec is None:
        return 5 * G * N * 4
    ws = codec.workspace(G, N, "meta")
    return 5 * G * N * 4 + 2 * sum(t.numel() * t.element_size() for t in ws.values())


def adamw_step_bytes(cfg, N: int) -> int:
    """One client's AdamW local step beyond the resident buffers,
    reckoned: its activations with its gradient row filling in
    (act_bytes + 4 N), or after the backward pass the gradient row and
    the update's f32 temporaries, at most three of a leaf's size at once
    (m / c1, the denominator and their quotient), of the largest leaf;
    the larger."""
    import torch
    from repro_torch.dist.flat import tree_flatten
    from repro_torch.models.model import init_params
    big = max(l.numel() for l in tree_flatten(
        init_params(cfg, torch.Generator(), device="meta"))[0])
    return max(act_bytes(cfg, TRAIN_SEQ) + 4 * N, 4 * N + 3 * 4 * big)


def plain_round(torch, buf, res_in, sched, codec):
    """The per-rank round of one rank holding every client, through the
    kernels' plain versions on the card, over column chunks: the self
    term ``mix_accumulate_ref(None, buf, self_w)``, then slot k's rows
    ``buf[perms[k]]`` (under int8-block: the plain ``quantize_block`` of
    ``buf + res_in``, its rows folded by ``dequant_accumulate_ref``) with
    weights ``weights[:, k]``.  Yields (a, b, out chunk, residual chunk
    or None)."""
    from repro_torch.kernels.ref import (dequant_accumulate_ref, mix_accumulate_ref,
                                         quantize_block_ref)
    w = torch.as_tensor(sched.weights, device="cuda")
    sw = torch.as_tensor(sched.self_weight, device="cuda")
    perms = [torch.as_tensor(p, device="cuda") for p in sched.perms]
    N = buf.shape[1]
    for a in range(0, N, CHUNK):
        b = min(a + CHUNK, N)
        x = buf[:, a:b]
        acc = mix_accumulate_ref(None, x, sw)
        res = None
        if codec is None:
            for k, p in enumerate(perms):
                acc = mix_accumulate_ref(acc, x[p], w[:, k])
        else:
            q, s, res = quantize_block_ref(x + res_in[:, a:b].to("cuda"), codec.block,
                                           codec.levels, with_residual=True)
            for k, p in enumerate(perms):
                acc = dequant_accumulate_ref(acc, q[p], s[p], w[:, k], codec.block)
        yield a, b, acc, res


def front_steps(torch, cfg, mesh, codec_name, card, seed):
    """FRONT_STEPS steps of launch/train.py's make_dfl_step on the
    script's one-rank NCCL group: FRONT_CLIENTS clients of ``cfg``, all on
    the rank, from the same seeded parameters, AdamW(3e-3, no weight
    decay), fedlay over FRONT_SPACES spaces on the flat path (compressed
    by ``codec_name`` with its residual), one TokenStream sequence of
    TRAIN_SEQ tokens a client and step.  Checks each step's launches,
    the losses finite, AdamW's count, the buffers' data_ptr, the peak
    memory, and the last step's mixing round against plain_round.
    Returns (losses, mean local ms, mean mixing ms, tokens a second,
    launches)."""
    import numpy as np
    from repro_torch.core.mixing import build_permute_schedule
    from repro_torch.data.tokens import TokenStream
    from repro_torch.dist.sync import make_mixer
    from repro_torch.kernels.gather_mix import gather_mix
    from repro_torch.kernels.mix_accumulate import mix_accumulate
    from repro_torch.kernels.wire_codec import (dequant_accumulate, dequantize_block,
                                                gather_mix_int8, quantize_block)
    from repro_torch.launch.train import make_dfl_step, rank_state
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import adamw
    from repro_torch.wire.codec import get_codec

    G, L = FRONT_CLIENTS, FRONT_SPACES
    codec = get_codec(codec_name)
    ef = codec is not None and codec.error_feedback
    name = codec_name or "codec-free"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    optimizer = adamw(FRONT_LR, weight_decay=0.0)
    t0 = time.perf_counter()
    p0 = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    state = rank_state(p0, G, optimizer, flat=True, codec=codec, error_feedback=ef)
    del p0
    torch.cuda.synchronize()
    N = state.params.shape[1]
    reckoned = front_resident(torch, codec, G, N) + adamw_step_bytes(cfg, N)
    print(f"front: {name}: {G} clients' state ({G}, {N}) f32, AdamW's mu and nu"
          f"{' and the residual' if ef else ''}, built in "
          f"{time.perf_counter() - t0:.1f} s")
    sched = build_permute_schedule(G, L)
    mixer = make_mixer("fedlay", sched, mesh.group, G, clients_per_device=G,
                       fuse="flat", codec=codec_name)
    mix_ms, snap = [], {}

    def timed_mixer(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if snap.get("keep") and ef:
            # the round's input residual, for the plain round; its copy
            # to the host is left out of the step's time
            snap["res_in"] = state.residual.to("cpu", copy=True)
            snap["copy_ms"] = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
        out = mixer(*args, **kw)
        torch.cuda.synchronize()
        mix_ms.append((time.perf_counter() - t) * 1e3)
        return out

    step = make_dfl_step(cfg, optimizer, timed_mixer, mesh.group, error_feedback=ef)
    streams = [iter(TokenStream(cfg.vocab_size, 1, TRAIN_SEQ, seed=seed, client=c))
               for c in range(G)]
    w = torch.as_tensor(sched.weights, device="cuda")
    sw = torch.as_tensor(sched.self_weight, device="cuda")
    ptrs = state.buffers()
    kernels = (mix_accumulate, quantize_block, dequant_accumulate, gather_mix,
               gather_mix_int8, dequantize_block)
    want = [2 * L + 1, 0, 0, 0, 0, 0] if codec is None else [1, 1, 2 * L, 0, 0, 0]
    losses, step_ms = [], []
    for k in kernels:
        k.launches = 0
    for i in range(FRONT_STEPS):
        xs, ys = zip(*(next(s) for s in streams))
        batch = {"tokens": torch.from_numpy(np.stack(xs)).to("cuda"),
                 "labels": torch.from_numpy(np.stack(ys)).to("cuda")}
        snap["keep"] = i == FRONT_STEPS - 1
        start = [k.launches for k in kernels]
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = float(step(state, batch, w, sw))
        step_ms.append((time.perf_counter() - t) * 1e3 - snap.pop("copy_ms", 0.0))
        got = [k.launches - a for k, a in zip(kernels, start)]
        check(got == want, f"front {name} step {i} launched "
              f"{dict(zip((k.__name__ for k in kernels), got))}")
        check(np.isfinite(loss), f"front {name} step {i} loss is not finite")
        losses.append(loss)
        print(f"front: {name} step {i}: loss {loss:.6f}; step {step_ms[-1]:.1f} ms "
              f"(local {step_ms[-1] - mix_ms[-1]:.1f}, mixing {mix_ms[-1]:.2f})")
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    count = state.opt_state["count"]
    check(bool((count == FRONT_STEPS).all()), f"AdamW's count {count.tolist()} after "
          f"{FRONT_STEPS} steps")
    check(state.buffers() == ptrs, "a resident buffer was reallocated")
    check(peak <= reckoned * (1 + PEAK_MARGIN),
          f"front {name}: peak memory {peak / 1e9:.2f} GB above the reckoned "
          f"{reckoned / 1e9:.2f} GB + {PEAK_MARGIN:.0%}")

    # the last step's mixing round through the plain versions on the card
    out, inp = state.params, state.spare
    err, scale = 0.0, 0.0
    for a, b, acc, res in plain_round(torch, inp, snap.get("res_in"), sched, codec):
        if res is not None:
            check(torch.equal(bits(state.residual[:, a:b]), bits(res)),
                  f"front {name}: the residual differs from the plain round's in "
                  f"columns {a}..{b}")
        err = max(err, (out[:, a:b] - acc).abs().max().item())
        scale = max(scale, inp[:, a:b].abs().max().item())
        del acc, res
    check(err <= 1e-6 * scale, f"front {name}: the last round differs from the plain "
          f"round by {err}")
    steady = step_ms[1:]
    mean_step = sum(steady) / len(steady)
    mean_mix = sum(mix_ms[1:]) / len(steady)
    tok_s = G * TRAIN_SEQ / (mean_step / 1e3)
    print(f"front: {name}: launches a step {dict(zip((k.__name__ for k in kernels), want))}"
          f" in each of {FRONT_STEPS} steps; AdamW's count {FRONT_STEPS} in every row; "
          f"resident buffers kept their data_ptr; the last round against the plain "
          f"versions on the card: "
          + ("residual bit for bit, " if ef else "")
          + f"max abs err {err:.3e} <= 1e-6 x max|buf| {scale:.3f}; peak memory "
          f"{peak / 1e9:.2f} GB <= {reckoned / 1e9:.2f} GB reckoned + {PEAK_MARGIN:.0%} "
          f"({card})")
    print(f"breakdown: front door {name} step at {cfg.num_layers} layer(s), {G} clients: "
          f"over steps 1-{FRONT_STEPS - 1} {mean_step:.1f} ms a step, local "
          f"{mean_step - mean_mix:.1f} ms and mixing {mean_mix:.2f} ms; "
          f"{tok_s:.1f} tokens/s ({G} x {TRAIN_SEQ} tokens a step); the caching "
          f"allocator freed its cache and retried {retries} time(s) ({card})")
    del state
    return losses, launches


def front_args(**kw):
    """launch/train.py's arguments at tiny_lm's defaults, as its parser
    gives them, with ``kw`` over them."""
    from repro_torch.launch.train import parser
    args = parser().parse_args([])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def ckpt_leaves(directory, step):
    from repro_torch.ckpt.checkpoint import load
    return load(str(Path(directory) / f"ckpt_{step:08d}"))[0]["leaves"]


def phase_front(torch, card, mesh, scratch: Path):
    """launch/train.py on the card: (a) make_dfl_step at Llama-3.2-3B
    width with its depth cut to what fits AdamW's state, codec-free and
    under int8-block; (b) the CLI at tiny_lm's defaults in a subprocess,
    the same run in-process on the script's group stopped at step 10 and
    resumed from its checkpoint, held to the subprocess bit for bit, and
    on the CPU."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels.mix_accumulate import mix_accumulate
    from repro_torch.kernels.wire_codec import dequant_accumulate, quantize_block
    from repro_torch.launch.mesh import ClientMesh
    from repro_torch.launch.train import run
    from repro_torch.wire.codec import get_codec

    base, G = REGISTRY["llama3.2-3b"], FRONT_CLIENTS
    cfg, N, resident, reckoned, limit = fit_depth(
        torch, base, lambda n: front_resident(torch, get_codec(FRONT_CODEC), G, n),
        adamw_step_bytes)
    print(f"front: launch/train.py's make_dfl_step at {base.name}'s full width cut to "
          f"{cfg.num_layers} of {base.num_layers} layers: the most whose reckoned "
          f"bytes under {FRONT_CODEC}, {resident / 1e9:.2f} GB resident (parameters, "
          f"AdamW's mu and nu, the mixer's output and the residual, 5 x {G} x N x 4, "
          f"N = {N}, and the wire twice, sent and received) + "
          f"{(reckoned - resident) / 1e9:.2f} GB for "
          f"the local step, stay within 80 % of the card's {limit / 0.8 / 1e9:.2f} GB; "
          f"{G} clients on the one-rank NCCL group, fedlay over {FRONT_SPACES} spaces, "
          f"AdamW lr {FRONT_LR}, 1 x {TRAIN_SEQ} tokens a client and step")
    free_losses, _ = front_steps(torch, cfg, mesh, None, card, seed=2000)
    codec_losses, launches = front_steps(torch, cfg, mesh, FRONT_CODEC, card, seed=2000)
    print(f"front: losses at {cfg.num_layers} layer(s), {FRONT_CODEC} against "
          f"codec-free, step by step: "
          + "; ".join(f"{a:.6f} / {b:.6f}" for a, b in zip(codec_losses, free_losses)))
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the command line, then the same run in-process, stopped and resumed
    cli = FRONT_CLI
    sub, own, cpu_dir = scratch / "cli", scratch / "inproc", scratch / "cpu"
    for d in (sub, own, cpu_dir):
        d.mkdir(parents=True)
    tel, out = sub / "telemetry.jsonl", sub / "out.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cuda",
           "--clients", str(cli["clients"]), "--clients-per-device", str(cli["clients"]),
           "--steps", str(cli["steps"]), "--fuse", "flat", "--codec", FRONT_CODEC,
           "--ckpt-dir", str(sub / "ckpt"), "--ckpt-every", str(cli["every"]),
           "--telemetry-out", str(tel), "--out", str(out)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT / "src")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"the front door's CLI exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    res = json.loads(out.read_text())
    rows = [json.loads(line) for line in tel.read_text().splitlines()]
    sub_losses = res["losses"]
    check(len(rows) == cli["steps"] and [r["round"] for r in rows] == list(range(cli["steps"])),
          f"the telemetry holds {len(rows)} rows, not {cli['steps']}")
    check(len(sub_losses) == cli["steps"] and sub_losses[-1] < sub_losses[0],
          f"the CLI's loss did not fall: {sub_losses[0]} -> {sub_losses[-1]}")
    print(f"front: `python -m repro_torch.launch.train --device cuda` at tiny_lm's "
          f"defaults, {cli['clients']} clients on one rank, {cli['steps']} steps, "
          f"--fuse flat --codec {FRONT_CODEC}, checkpoints every {cli['every']}: exit 0 "
          f"in {wall:.1f} s (its process's start and its group included); loss "
          f"{sub_losses[0]:.6f} -> {sub_losses[-1]:.6f}; {len(rows)} telemetry rows, "
          f"wire {rows[-1]['wire_bytes_per_client']} B a client (one rank: no network)")

    kw = dict(clients=cli["clients"], clients_per_device=cli["clients"], fuse="flat",
              codec=FRONT_CODEC, ckpt_every=cli["every"], ckpt_dir=str(own / "ckpt"),
              log_every=100)
    kernels = (mix_accumulate, quantize_block, dequant_accumulate)
    for k in kernels:
        k.launches = 0
    first = run(front_args(steps=cli["stop"], **kw), mesh)
    second = run(front_args(steps=cli["steps"], **kw), mesh)
    counts = {k.__name__: k.launches for k in kernels}
    torch.cuda.synchronize()
    L = front_args().spaces
    steps = cli["steps"]
    want = {"mix_accumulate": steps, "quantize_block": steps,
            "dequant_accumulate": 2 * L * steps}
    check(counts == want, f"the in-process runs launched {counts}, not {want}")
    check(second["start_step"] == cli["stop"], f"the second run started at "
          f"{second['start_step']}, not {cli['stop']}")
    check(first["losses"] == sub_losses[:cli["stop"]],
          "the in-process run's first losses differ from the CLI's: "
          f"{first['losses']} vs {sub_losses[:cli['stop']]}")
    check(second["losses"] == sub_losses[cli["stop"]:],
          "the resumed run's losses differ from the CLI's: "
          f"{second['losses']} vs {sub_losses[cli['stop']:]}")
    mine, theirs = ckpt_leaves(own / "ckpt", steps), ckpt_leaves(sub / "ckpt", steps)
    check(len(mine) == len(theirs), "the final checkpoints hold different leaf counts")
    for i, (a, b) in enumerate(zip(mine, theirs)):
        check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(bits(a), bits(b)),
              f"leaf {i} of the final checkpoint differs from the CLI's: max abs diff "
              f"{(a.double() - b.double()).abs().max().item()}")
    print(f"front: in-process run(args, mesh) on the script's group to step {cli['stop']}, "
          f"then resumed from its checkpoint at step {second['start_step']} to "
          f"{steps}: launches {counts}; losses of steps 0-{steps - 1} and all "
          f"{len(mine)} leaves of the final checkpoint bit for bit with the CLI's")

    group = dist.new_group(backend="gloo")
    cpu_mesh = ClientMesh(group=group, rank=0, size=1, device=torch.device("cpu"))
    threads = torch.get_num_threads()
    t0 = time.perf_counter()
    on_cpu = run(front_args(device="cpu", steps=steps,
                            **{**kw, "ckpt_dir": str(cpu_dir / "ckpt")}), cpu_mesh)
    cpu_s = time.perf_counter() - t0
    dist.destroy_process_group(group)
    err = max(abs(a - b) / abs(b) for a, b in zip(on_cpu["losses"], sub_losses))
    check(err <= FRONT_CPU_TOL, f"the CPU run's losses differ from the card's by "
          f"{err:.3e} relative")
    print(f"front: the same {steps} steps on the CPU (gloo, {threads} threads, "
          f"{cpu_s:.1f} s): losses within {err:.3e} relative of the card's (tol "
          f"{FRONT_CPU_TOL}); the card's {sub_losses[-1]:.6f}, the CPU's "
          f"{on_cpu['losses'][-1]:.6f}")
    return launches



def front_step_turns(torch, card, mesh) -> bool:
    """``--front-step``: the ``front`` phase's codec-free steps
    (:func:`front_steps` at the same depth) in a process that ran no
    other phase, in three turns: the embedding as the port computes it
    (``F.embedding``; the process's first steps), through indexing
    (``table[tokens]``, whose backward is an accumulating ``index_put_``:
    the port's embedding before ``F.embedding``), and ``F.embedding``
    again.  Each turn prints its steps and its breakdown; a turn's
    failed check is printed and the mode exits 1."""
    import repro_torch.models.model as model
    from repro_torch.configs import REGISTRY
    from repro_torch.wire.codec import get_codec
    cfg = fit_depth(torch, REGISTRY["llama3.2-3b"], lambda n: front_resident(
        torch, get_codec(FRONT_CODEC), FRONT_CLIENTS, n), adamw_step_bytes)[0]
    committed, ok = model.embed_apply, True
    for label, embed in (("F.embedding, first", committed),
                         ("indexing", lambda table, tokens: table[tokens]),
                         ("F.embedding, again", committed)):
        print(f"front-step turn: the embedding through {label}, {cfg.num_layers} "
              f"layer(s)")
        model.embed_apply = embed
        try:
            front_steps(torch, cfg, mesh, None, card, seed=2000)
        except RuntimeError as err:
            ok = False
            print(f"front-step turn {label}: {err}")
        finally:
            model.embed_apply = committed
        gc.collect()
        torch.cuda.empty_cache()
    return ok


# --------------------------------------------------------------------------
# Churn, faults and scale
# --------------------------------------------------------------------------

CHURN_NODES, CHURN_STEPS = 8, 8
#: a fail, the same id's rejoin (the first alive set again, so the mixer
#: must come out of the cache) and a new id's join, whose row its donor's
CHURN_TRACE = [(1.5, "fail", 3), (3.5, "join", 3, 0), (5.5, "join", 70, 0)]
CHURN_ALIVE = [8, 7, 7, 8, 8, 9, 9, 9]
#: the reference's fault_storm benchmark at its full size
#: (``benchmarks/fault_storm.py``), with rows of the MNIST MLP's width
STORM_N, STORM_DIM, STORM_MAX_ROUNDS = 16, 50_890, 400
STORM_BOUND, STORM_SPREAD = 3.0, 1e-3          # ROUNDS_RATIO_BOUND, TARGET_SPREAD
STORM_PARTITION, STORM_STRAGGLE = (2.0, 14.0), (2.0, 18.0)
#: (name, loss, partition, stragglers, repair): the reference's four arms,
#: then its partition arm with a HealthTracker and a RepairPolicy, whose
#: backoff moves the clock past the fault windows in a few rounds
STORM_ARMS = [("clean", 0.0, False, 0, False), ("loss", 0.10, False, 0, False),
              ("loss+straggle", 0.10, False, 2, False),
              ("loss+partition+straggle", 0.10, True, 2, False),
              ("loss+partition+straggle+repair", 0.10, True, 2, True)]
#: the reference's cohort_stream benchmark at its full size
#: (``benchmarks/cohort_stream.py``), with rows of the MNIST MLP's width
COHORT_N, COHORT_CAPACITY, COHORT_KS, COHORT_ROUNDS = 50_000, 128, (32, 64, 128), 24
COHORT_DIM, COHORT_SPACES, COHORT_ORACLE_N = 50_890, 3, 120


def churn_loop(torch, cfg, device, seed, seq, draw_on=None, loop_cls=None, timed=None):
    """A ChurnTrainLoop over ``cfg`` on ``device``: ``CHURN_NODES`` seeded
    nodes, sgd(0.05) through ``dfl_train_bundle(sync="none")``, fedlay
    over 2 spaces through the flat mixer (``OverlayController(fuse=
    "flat")``); parameters from generators on ``draw_on`` (default
    ``device``) seeded by node, one sequence of ``seq`` tokens a client
    and step from numpy keyed by (node, step)."""
    import numpy as np
    from repro_torch.core.ndmp import Simulator
    from repro_torch.dist.flat import tree_map
    from repro_torch.dist.sync import global_mixer
    from repro_torch.launch.steps import dfl_train_bundle
    from repro_torch.models.config import InputShape
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import sgd
    from repro_torch.overlay import ChurnTrainLoop, OverlayController

    def make_params(node):
        gen = torch.Generator(device=draw_on or device).manual_seed(seed + node)
        return tree_map(lambda l: l.to(device), init_params(cfg, gen))

    box = {}

    def make_batch(ids, _):
        # the loop's own step count (every run() call starts its index at 0)
        step = len(box["loop"].records)
        toks = np.stack([np.random.default_rng([u, step]).integers(
            0, cfg.vocab_size, (1, seq + 1)) for u in ids])
        t = torch.from_numpy(toks).to(device)
        return {"tokens": t[..., :-1], "labels": t[..., 1:]}

    sim = Simulator(num_spaces=2, latency=0.05, heartbeat_period=0.5,
                    probe_period=1.0, seed=0)
    sim.seed_network(list(range(CHURN_NODES)))
    factory = None
    if timed is not None:
        factory = lambda sched: timed(global_mixer("fedlay", sched, fuse="flat"), "mix")  # noqa: E731
    ctl = OverlayController(sim, fuse="flat", mixer_factory=factory)
    step = dfl_train_bundle(cfg, InputShape("churn", seq, 1, "train"), 1, sgd(0.05),
                            sync="none").step
    box["loop"] = (loop_cls or ChurnTrainLoop)(
        ctl, local_step=timed(step, "local") if timed else step,
        make_params=make_params, optimizer=sgd(0.05), make_batch=make_batch)
    return box["loop"]


def small_churn(torch):
    """tiny_lm under ChurnTrainLoop on the card and on the CPU, the same
    parameters, data and churn: the same alive sequence and swapped /
    cache-hit flags, and each step's loss within 1e-4 relative (f32 on
    both; the card sums in other orders)."""
    from repro_torch.configs import tiny_lm
    from repro_torch.overlay.events import ChurnTrace
    runs = []
    for device in ("cpu", "cuda"):
        loop = churn_loop(torch, tiny_lm(), device, seed=0, seq=64, draw_on="cpu")
        recs = loop.run(CHURN_STEPS, trace=ChurnTrace.scripted(CHURN_TRACE))
        runs.append(([(r.num_alive, r.swapped, r.cache_hit) for r in recs],
                     [r.loss for r in recs]))
    (cpu_flags, cpu_loss), (gpu_flags, gpu_loss) = runs
    check(cpu_flags == gpu_flags, f"churn records differ: {cpu_flags} vs {gpu_flags}")
    check([f[0] for f in gpu_flags] == CHURN_ALIVE, f"tiny_lm churn alive {gpu_flags}")
    err = max(abs(a - b) / abs(b) for a, b in zip(gpu_loss, cpu_loss))
    check(err <= 1e-4, f"tiny_lm churn losses differ by {err:.3e} relative")
    print(f"churn: tiny_lm ChurnTrainLoop, {CHURN_STEPS} steps with a fail, a rejoin "
          f"and a join: card == CPU alive sequence {[f[0] for f in gpu_flags]}, "
          f"swapped and cache-hit flags equal, max loss difference {err:.3e} "
          f"relative (tol 1e-4)")


def churn_full(torch, card) -> int:
    """(a) ChurnTrainLoop over Llama-3.2-3B at full width, its depth cut
    to what fits the re-stack reckoning, under CHURN_TRACE; returns its
    gather_mix launches."""
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.dist import sync
    from repro_torch.dist.flat import tree_flatten
    from repro_torch.kernels.gather_mix import gather_mix
    from repro_torch.kernels.ref import gather_mix_ref
    from repro_torch.overlay import ChurnTrainLoop, joiner_donors
    from repro_torch.overlay.events import ChurnTrace

    base = REGISTRY["llama3.2-3b"]
    C = CHURN_NODES + 1            # the most clients the trace holds at once
    # the stack, and beside it either the local step, or the mixer's
    # raveled copy and output, or a remap's new stack: the larger
    cfg, N, resident, reckoned, limit = fit_depth(
        torch, base, lambda n: C * n * 4,
        lambda c, n: max(local_step_bytes(c, n), 2 * C * n * 4))
    print(f"churn: {base.name} at full width cut to {cfg.num_layers} of "
          f"{base.num_layers} layers: the most whose reckoned bytes, the stack "
          f"{resident / 1e9:.2f} GB ({C} x N x 4, N = {N}) + "
          f"{(reckoned - resident) / 1e9:.2f} GB (the larger of the local step and "
          f"2 x {C} x N x 4: the flat mixer's raveled copy and output, or a remap's "
          f"new stack), stay within 80 % of the card's {limit / 0.8 / 1e9:.2f} GB; "
          f"{CHURN_NODES} nodes, {CHURN_STEPS} steps, 1 x {TRAIN_SEQ} tokens a client, "
          f"sgd lr 0.05 ({card})")

    times = {"remap": [], "local": [], "mix": []}

    def timed(fn, key):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    moves = {"survivors": 0, "joiners": []}

    class CheckedLoop(ChurnTrainLoop):
        """Holds every remap to node identity as it lands: a survivor's
        rows bit for bit at its new position, a joiner's its donor's."""

        def _remap(self, report):
            old, old_params = self.assignment, self.params
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            joined, left = super()._remap(report)
            torch.cuda.synchronize()
            times["remap"].append((time.perf_counter() - t0) * 1e3)
            new = self.assignment
            donors = joiner_donors(self.controller.schedule, new, joined,
                                   [u for u in new if u in old])
            for u in new:
                if u in old:
                    src = old.index(u)
                    moves["survivors"] += 1
                else:
                    check(donors[u] is not None, f"joiner {u} has no donor")
                    src = old.index(donors[u])
                    moves["joiners"].append((u, donors[u]))
                for a, b in zip(tree_flatten(self.params)[0], tree_flatten(old_params)[0]):
                    check(torch.equal(a[new.index(u)], b[src]),
                          f"node {u}'s row did not move by identity")
            return joined, left

    last, hold = {}, {"on": False}
    real_gather_mix = sync.gather_mix

    def recording(buf, srcs, weights, out=None):
        out = real_gather_mix(buf, srcs, weights, out=out)
        if hold["on"]:
            last.update(buf=buf, srcs=srcs, weights=weights, out=out)
        return out

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop = churn_loop(torch, cfg, "cuda", seed=2000, seq=TRAIN_SEQ,
                      loop_cls=CheckedLoop, timed=timed)
    torch.cuda.synchronize()
    print(f"churn: {CHURN_NODES} clients drawn in {time.perf_counter() - t0:.1f} s")
    trace = ChurnTrace.scripted(CHURN_TRACE)
    walls = []
    sync.gather_mix = recording
    try:
        gather_mix.launches = 0
        for r in range(CHURN_STEPS):
            hold["on"] = r == CHURN_STEPS - 1
            n_remap = len(times["remap"])
            retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
            t0 = time.perf_counter()
            rec = loop.run(1, trace=trace)[-1]
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
            remap = times["remap"][-1] if len(times["remap"]) > n_remap else 0.0
            print(f"churn: step {r}: {rec.num_alive} alive (joined {list(rec.joined)}, "
                  f"left {list(rec.left)}; swapped {rec.swapped}, cache hit "
                  f"{rec.cache_hit}), loss {rec.loss:.6f}; host {walls[-1]:.1f} ms: "
                  f"remap {remap:.1f}, local step {times['local'][-1]:.1f}, mixing "
                  f"{times['mix'][-1]:.2f}; allocator retries {retries}")
            check(np.isfinite(rec.loss), f"churn step {r} loss is not finite")
        launches = gather_mix.launches
    finally:
        sync.gather_mix = real_gather_mix
        hold["on"] = False
    peak = torch.cuda.max_memory_allocated()
    recs = loop.records
    check(launches == CHURN_STEPS, f"gather_mix launches {launches} != {CHURN_STEPS} steps")
    check([r.num_alive for r in recs] == CHURN_ALIVE,
          f"churn alive sequence {[r.num_alive for r in recs]}")
    check(recs[3].joined == (3,) and recs[3].swapped and recs[3].cache_hit,
          f"the rejoin of node 3 was not a cache hit: {recs[3]}")
    check([u for u, _ in moves["joiners"]] == [3, 70], f"joiners {moves['joiners']}")
    check(peak <= reckoned * (1 + PEAK_MARGIN),
          f"churn peak memory {peak / 1e9:.2f} GB above the reckoned "
          f"{reckoned / 1e9:.2f} GB + {PEAK_MARGIN:.0%}")
    print(f"churn: gather_mix launches {launches} = {CHURN_STEPS} steps; the rejoin "
          f"of node 3 (step 3) a MixerCache hit ({loop.controller.cache.hits} hits, "
          f"{loop.controller.cache.misses} misses); {moves['survivors']} survivor "
          f"rows moved by identity bit for bit over 3 remaps; joiners 3 and 70 == "
          f"donors {moves['joiners'][0][1]} and {moves['joiners'][1][1]} bit for bit "
          f"before their first local step; peak "
          f"memory {peak / 1e9:.2f} GB <= {reckoned / 1e9:.2f} GB reckoned + "
          f"{PEAK_MARGIN:.0%} ({card})")

    # the last step's mixing against the plain version, chunk by chunk
    buf, out = last["buf"], last["out"]
    err = scale = 0.0
    for a in range(0, buf.shape[1], CHUNK):
        ref = gather_mix_ref(buf[:, a:a + CHUNK], last["srcs"], last["weights"])
        err = max(err, (out[:, a:a + CHUNK] - ref).abs().max().item())
        scale = max(scale, buf[:, a:a + CHUNK].abs().max().item())
    check(err <= 1e-6 * scale, f"churn mixing differs from the plain version by {err}")
    print(f"churn: step {CHURN_STEPS - 1}'s mixing ({buf.shape[0]}, {buf.shape[1]}) vs "
          f"gather_mix_ref: max abs err {err:.3e} <= 1e-6 x max|buf| {scale:.3f}")
    last.clear()
    steady = range(1, CHURN_STEPS)
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    print(f"breakdown: churn step at {cfg.num_layers} layers over steps 1-"
          f"{CHURN_STEPS - 1}: host {mean([walls[i] for i in steady]):.1f} ms a step; "
          f"local step {mean([times['local'][i] for i in steady]):.1f} ms "
          f"({mean([times['local'][i] / recs[i].num_alive for i in steady]):.1f} a "
          f"client), mixing {mean([times['mix'][i] for i in steady]):.2f} ms; a remap "
          f"{mean(times['remap']):.1f} ms (3 remaps: "
          + ", ".join(f"{t:.1f}" for t in times["remap"]) + f") ({card})")
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def storm_plan(n, loss, partition, stragglers):
    """The fault_storm benchmark's seeded storm: ``loss`` NDMP message loss
    for the whole run, one 2-way partition over STORM_PARTITION healed at
    its end, and ``stragglers`` slow nodes over STORM_STRAGGLE."""
    from repro_torch.faults import FaultPlan, Partition, Straggler
    parts = ()
    if partition:
        half = tuple(range(n // 2)), tuple(range(n // 2, n))
        parts = (Partition(start=STORM_PARTITION[0], end=STORM_PARTITION[1], groups=half),)
    slow = tuple(Straggler(start=STORM_STRAGGLE[0], end=STORM_STRAGGLE[1], node=n - 1 - i)
                 for i in range(stragglers))
    return FaultPlan(seed=7, msg_loss=loss, partitions=parts, stragglers=slow)


def storm_sim(seed=0):
    from repro_torch.core.ndmp import Simulator
    sim = Simulator(num_spaces=2, latency=0.05, heartbeat_period=0.5, probe_period=1.0,
                    seed=seed)
    sim.seed_network(list(range(STORM_N)))
    return sim


def storm_arm(torch, arm, device) -> dict:
    """One fault_storm arm on ``device``: a SlotTrainLoop of capacity
    STORM_N over a ChaosEngine, an identity local step (only mixing moves
    the rows), rows of STORM_DIM f32 from ``default_rng(node)``, run a
    round at a time until every live row is within STORM_SPREAD of the
    live mean.  The repair arm also has a HealthTracker (node 0
    suspected at round 3, evicted after 1 s, healed at round 9) and a
    RepairPolicy on the controller."""
    import numpy as np
    from repro_torch.faults import BackoffPolicy, ChaosEngine, HealthTracker, RepairPolicy
    from repro_torch.obs.rounds import RoundLedger
    from repro_torch.optim.optimizers import sgd
    from repro_torch.overlay import OverlayController
    from repro_torch.runtime.loop import SlotTrainLoop
    from repro_torch.runtime.masked import masked_local_step

    name, loss, part, slow, repair = arm
    chaos = ChaosEngine(storm_sim(), storm_plan(STORM_N, loss, part, slow))
    ctl = OverlayController(chaos, capacity=STORM_N, fuse="flat", flat_io=True,
                            repair_policy=RepairPolicy(backoff=BackoffPolicy(seed=7))
                            if repair else None)
    masks, split = [], []

    class Recorded(SlotTrainLoop):
        def _edge_mask(self, now):
            em, degraded = super()._edge_mask(now)
            masks.append(None if em is None else em.copy())
            split.append(chaos.data_faults().groups is not None)
            return em, degraded

    def step(params, opt_state, batch):
        return params, opt_state, {"loss": (params["w"] ** 2).mean(dim=-1)}

    ledger = RoundLedger()
    loop = Recorded(
        ctl, local_step=masked_local_step(step),
        make_params=lambda u: {"w": torch.from_numpy(np.random.default_rng(u).normal(
            size=STORM_DIM).astype(np.float32)).to(device)},
        optimizer=sgd(0.0),
        make_batch=lambda ids, s: {"x": torch.zeros((len(ids), 1), device=device)},
        ledger=ledger, health=HealthTracker(1.0) if repair else None)
    ptrs = {loop.params.data_ptr(), loop._spare.data_ptr()}
    kept = True
    reached = False
    for r in range(STORM_MAX_ROUNDS):
        if repair and r == 3:
            loop.health.suspect(0, ctl.sim.now)
        if repair and r == 9:
            check(loop.health.heal(0, loop.health.version_of(0)), "heal refused")
        loop.run(1)
        kept &= {loop.params.data_ptr(), loop._spare.data_ptr()} == ptrs
        slots = torch.as_tensor([ctl.slots.slot_of[u] for u in ctl.alive], device=device)
        rows = loop.state.tree()["w"].index_select(0, slots)
        if (rows - rows.mean(dim=0)).abs().max().item() < STORM_SPREAD:
            reached = True
            break
    fault_end = max(STORM_STRAGGLE[1] if slow else 0.0, STORM_PARTITION[1] if part else 0.0)
    return {"name": name, "rounds": r + 1, "reached": reached, "masks": masks,
            "injected": [x.extra["faults_injected"] for x in ledger.rows],
            "degraded": sum(x.extra["degraded_edges"] for x in ledger.rows),
            "fault_end_round": sum(rec.time <= fault_end for rec in loop.records)
            if fault_end else 0,
            "rows": loop.state.tree()["w"].cpu(), "kept": kept,
            "counts": dict(chaos.counts), "correctness": chaos.correctness(),
            "repair": (ctl.repair_retries, ctl.repair_recovered, ctl.repair_gave_up),
            "partitioned": sum(split), "partition": part, "repairs": repair,
            "time": chaos.now}


def repair_latency() -> float:
    """Simulated seconds from the partition's heal until NDMP correctness
    is back to 1.0 on the object engine under 10 % loss, in 0.5 s steps
    (the benchmark's ``_repair_latency``)."""
    from repro_torch.faults import ChaosEngine
    sim = ChaosEngine(storm_sim(seed=1), storm_plan(STORM_N, 0.10, True, 0))
    t = STORM_PARTITION[1]
    sim.run_until(t)
    while sim.correctness() < 1.0 and t - STORM_PARTITION[1] < 120.0:
        t += 0.5
        sim.run_until(t)
    return t - STORM_PARTITION[1]


def churn_storm(torch, card) -> int:
    """(b) The fault_storm arms on the card, each held to the same arm on
    the CPU; returns their gather_mix launches."""
    import numpy as np
    from repro_torch.kernels.gather_mix import gather_mix
    total, clean = 0, None
    for arm in STORM_ARMS:
        t0 = time.perf_counter()
        gather_mix.launches = 0
        got = storm_arm(torch, arm, "cuda")
        torch.cuda.synchronize()
        launches = gather_mix.launches
        wall = time.perf_counter() - t0
        cpu = storm_arm(torch, arm, "cpu")
        name, rounds = got["name"], got["rounds"]
        check(got["reached"], f"storm arm {name} did not reach the spread in "
              f"{STORM_MAX_ROUNDS} rounds")
        check(launches == rounds, f"storm arm {name}: {launches} launches, {rounds} rounds")
        check(got["kept"], f"storm arm {name}: a round's buffer was reallocated")
        check(rounds == cpu["rounds"], f"storm arm {name}: {rounds} rounds on the card, "
              f"{cpu['rounds']} on the CPU")
        check(all((a is None and b is None) or np.array_equal(a, b)
                  for a, b in zip(got["masks"], cpu["masks"])),
              f"storm arm {name}: an edge mask differs between card and CPU")
        check(got["injected"] == cpu["injected"] and got["counts"] == cpu["counts"],
              f"storm arm {name}: faults_injected differs between card and CPU")
        scale = cpu["rows"].abs().max().item()
        err = (got["rows"] - cpu["rows"]).abs().max().item()
        check(err <= 1e-6 * scale, f"storm arm {name}: rows differ from the CPU by {err}")
        if clean is None:
            clean = rounds
            gate = "the baseline"
        elif got["fault_end_round"]:
            recovery = rounds - got["fault_end_round"]
            check(recovery <= STORM_BOUND * clean, f"storm arm {name}: {recovery} rounds "
                  f"past its fault window, above {STORM_BOUND} x {clean}")
            gate = (f"{recovery} rounds past the fault window's last round "
                    f"{got['fault_end_round']} <= {STORM_BOUND} x {clean}")
        else:
            check(rounds <= STORM_BOUND * clean, f"storm arm {name}: {rounds} rounds, "
                  f"above {STORM_BOUND} x {clean}")
            gate = f"ratio {rounds / clean:.2f} <= {STORM_BOUND}"
        if got["partition"]:
            check(got["correctness"] == 1.0, f"correctness {got['correctness']} after the heal")
        if got["partition"] and not got["repairs"]:
            check(got["partitioned"] > 0, f"storm arm {name} mixed through no partitioned "
                  "round")
        total += launches
        print(f"churn: storm arm {name}: {rounds} rounds to spread < {STORM_SPREAD} "
              f"({gate}); rounds with a partitioned mask {got['partitioned']}; "
              f"faults injected {sum(got['injected'])} "
              f"({got['counts']}), degraded edge-rounds {got['degraded']}; "
              f"repair retries / recovered / gave up {got['repair']}; simulated "
              f"{got['time']:.1f} s, correctness {got['correctness']}; gather_mix "
              f"launches {launches} = rounds; card == CPU: rounds, every edge mask and "
              f"faults_injected; rows max abs err {err:.3e} <= 1e-6 x max|row| "
              f"{scale:.3f}; data_ptr unchanged; {wall:.2f} s on the card ({card})")
    latency = repair_latency()
    check(latency < 60.0, f"repair latency {latency} s")
    print(f"churn: repair latency after the partition's heal (object engine, 10 % "
          f"loss, n {STORM_N}): {latency:.1f} simulated s to correctness 1.0")
    return total


def cohort_sim(n):
    from repro_torch.scale import VectorSimulator
    sim = VectorSimulator(num_spaces=COHORT_SPACES, latency=0.05, heartbeat_period=0.5,
                          probe_period=1.0)
    sim.seed_network(range(n))
    return sim


def cohort_params(u):
    import numpy as np
    return np.random.default_rng(u).random(COHORT_DIM).astype(np.float32)


def cohort_oracle(torch):
    """The device round against the dense oracle: three compositions of
    a COHORT_ORACLE_N-node overlay at capacity COHORT_CAPACITY through
    gather_mix with device tables, each within 1e-6 of M @ buf in f64;
    the full population's matrix equal to the dense full-participation
    matrix."""
    import numpy as np
    from repro_torch.core.mixing import schedule_from_addresses, schedule_mixing_matrix
    from repro_torch.kernels.gather_mix import gather_mix
    from repro_torch.scale import CohortSampler
    from repro_torch.scale.cohort import (cohort_addresses, cohort_mixing_matrix,
                                          cohort_schedule, schedule_tables)
    n, C = COHORT_ORACLE_N, COHORT_CAPACITY
    sim = cohort_sim(n)
    alive = tuple(sim.alive_ids())
    buf = np.random.default_rng(0).random((C, COHORT_DIM), dtype=np.float32)
    buf_t = torch.from_numpy(buf).cuda()
    out = torch.empty_like(buf_t)
    sampler = CohortSampler(sim, n // 2, seed=7)
    worst = 0.0
    for cohort in (alive, sampler.sample(0), sampler.sample(1)):
        slot_of = {int(u): j for j, u in enumerate(cohort)}
        _, padded = cohort_schedule(cohort, COHORT_SPACES, slot_of, C)
        srcs, weights = schedule_tables(padded)
        gather_mix(buf_t, torch.from_numpy(srcs).cuda(), torch.from_numpy(weights).cuda(),
                   out=out)
        oracle = cohort_mixing_matrix(cohort, COHORT_SPACES, slot_of, C) @ buf.astype(np.float64)
        diff = float(np.abs(out.cpu().numpy().astype(np.float64) - oracle).max())
        check(diff <= 1e-6, f"cohort round differs from the dense oracle by {diff}")
        worst = max(worst, diff)
    slot_of = {int(u): j for j, u in enumerate(alive)}
    M = cohort_mixing_matrix(alive, COHORT_SPACES, slot_of, C)
    dense = schedule_mixing_matrix(schedule_from_addresses(
        cohort_addresses(alive, COHORT_SPACES)))
    check(np.array_equal(M[:n, :n], dense) and np.array_equal(M[n:, n:], np.eye(C - n)),
          "the full-population cohort's matrix is not the dense full-participation one")
    print(f"churn: cohort round vs the dense oracle, {n} nodes, capacity {C}, 3 "
          f"compositions (K {n}, {n // 2}, {n // 2}), rows of {COHORT_DIM} f32, device "
          f"tables: max abs diff {worst:.3e} (tol 1e-6, f64 oracle); the full "
          f"population's matrix == the dense full-participation matrix exactly")


def cohort_stream(torch, k, device, rounds):
    """The cohort_stream benchmark's stream for cohort ``k`` on ``device``:
    ``rounds`` rounds over COHORT_N nodes at capacity COHORT_CAPACITY,
    with 1 % of the nodes failed and 1 % new ids joined at mid-run and
    30 s of settling.  Returns (loop, seconds, buffers kept)."""
    from repro_torch.scale import CohortStreamLoop
    sim = cohort_sim(COHORT_N)
    loop = CohortStreamLoop(sim, capacity=COHORT_CAPACITY, cohort_size=k,
                            make_params=cohort_params, seed=3, device=device)
    ptrs = {loop.buf.data_ptr(), loop.spare.data_ptr()}
    kept = True
    t0 = time.perf_counter()
    for r in range(rounds):
        if r == rounds // 2:
            burst = COHORT_N // 100
            sim.fail_batch(range(burst))
            sim.join_batch(range(COHORT_N + 1000, COHORT_N + 1000 + burst))
            sim.run_for(30.0)
        loop.run(1)
        kept &= {loop.buf.data_ptr(), loop.spare.data_ptr()} == ptrs
    if device == "cuda":
        torch.cuda.synchronize()
    return loop, time.perf_counter() - t0, kept


def churn_cohort(torch, card) -> int:
    """(c) Cohort streaming at population scale on the card, each K held
    to the same calls on the CPU; returns its gather_mix launches."""
    import numpy as np
    from repro_torch.kernels.gather_mix import _sm_count, gather_mix, launch_plan
    from repro_torch.kernels.ref import gather_mix_ref, round_matrix
    cohort_oracle(torch)
    fields = lambda r: (r.round, r.time, r.cohort_size, r.streamed_in,  # noqa: E731
                        r.streamed_out, r.restored, r.donor_seeded, r.fresh, r.evicted)
    total = 0
    for k in COHORT_KS:
        gather_mix.launches = 0
        loop, secs, kept = cohort_stream(torch, k, "cuda", COHORT_ROUNDS)
        launches = gather_mix.launches
        cpu, _, _ = cohort_stream(torch, k, "cpu", COHORT_ROUNDS)
        recs = loop.records
        check(launches == COHORT_ROUNDS, f"cohort K {k}: {launches} launches")
        check(kept, f"cohort K {k}: a resident buffer was reallocated")
        check([fields(r) for r in recs] == [fields(r) for r in cpu.records],
              f"cohort K {k}: records differ between card and CPU")
        check(list(loop.park) == list(cpu.park), f"cohort K {k}: parks differ")
        scale = cpu.buf.abs().max().item()
        err = (loop.buf.cpu() - cpu.buf).abs().max().item()
        check(err <= 1e-6 * scale, f"cohort K {k}: rows differ from the CPU by {err}")
        total += launches
        remap = [r.remap_ms for r in recs]
        print(f"churn: cohort K {k}: {COHORT_ROUNDS} rounds over {COHORT_N} nodes at "
              f"capacity {COHORT_CAPACITY} (a burst of {COHORT_N // 100} fails and "
              f"{COHORT_N // 100} joins at round {COHORT_ROUNDS // 2}) in {secs:.2f} s: "
              f"{COHORT_ROUNDS / secs:.2f} rounds/s, remap {float(np.mean(remap)):.2f} ms "
              f"a round (median {float(np.median(remap)):.2f}); streamed in "
              f"{sum(r.streamed_in for r in recs)}, restored "
              f"{sum(r.restored for r in recs)}, donor-seeded "
              f"{sum(r.donor_seeded for r in recs)}, fresh {sum(r.fresh for r in recs)}, "
              f"evicted {sum(r.evicted for r in recs)}, parked {len(loop.park)}; "
              f"gather_mix launches {launches} = rounds; card == CPU records and park, "
              f"rows max abs err {err:.3e} <= 1e-6 x max|buf|; data_ptr unchanged "
              f"({card})")
        del cpu
        if k != COHORT_KS[-1]:
            del loop
    # the kernel at the round's shape: the last loop's buffers and tables
    C, N = loop.buf.shape
    ms = device_ms(torch, [lambda: gather_mix(loop.buf, loop.srcs, loop.weights,
                                              out=loop.spare)], 50)
    plain_ms = device_ms(torch, [lambda: gather_mix_ref(loop.buf, loop.srcs,
                                                        loop.weights)], 10)
    # the yardstick's dense W only: the gather body builds no round matrix
    W = round_matrix(C, loop.srcs, loop.weights)
    library_ms = device_ms(torch, [lambda: torch.matmul(W, loop.buf, out=loop.spare)], 50)
    K1 = loop.srcs.shape[1]
    plan = launch_plan(C, K1, N, 4, loop.buf.data_ptr(), loop.spare.data_ptr(), _sm_count(0))
    # the function needs each row's K1 sources (C x K1 x N products) and
    # its bytes
    bound_ms = max(2 * C * N * 4 / HBM_BYTES_PER_S, 2 * C * K1 * N / F32_FLOPS_PER_S) * 1e3
    check(ms <= library_ms, f"gather_mix at the cohort round, {ms:.4f} ms, is slower "
          f"than torch.matmul(W, buf), {library_ms:.4f} ms")
    print(f"churn: gather_mix f32 at the cohort round's shape C = {C}, K1 = {K1}, "
          f"N = {N}, device tables, {plan_name(plan)}: kernel {ms:.4f} ms a round, "
          f"plain {plain_ms:.4f} ms, torch.matmul(W, buf) {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms (bytes, 2 x C x N x 4 at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
          f"{100 * bound_ms / ms:.1f} % of it) ({card})")
    return total


def phase_churn(torch, card) -> int:
    """The churn phase: (a) the re-stacking churn loop at full width, with
    its tiny_lm twin on the CPU; (b) the fault storm; (c) cohort
    streaming.  Returns the gather_mix launches of the three."""
    t0 = time.perf_counter()
    small_churn(torch)
    launches = {"churn": churn_full(torch, card)}
    t1 = time.perf_counter()
    launches["storm"] = churn_storm(torch, card)
    t2 = time.perf_counter()
    launches["cohort"] = churn_cohort(torch, card)
    t3 = time.perf_counter()
    print(f"churn: phase {t3 - t0:.1f} s (churn loop {t1 - t0:.1f}, storm {t2 - t1:.1f}, "
          f"cohort {t3 - t2:.1f}); gather_mix launches {launches}")
    return sum(launches.values())


# --------------------------------------------------------------------------
# The paper's DFL engine
# --------------------------------------------------------------------------

DFL_CLIENTS, DFL_SHARDS, DFL_SPACES = 100, 3, 3
#: fedlay's length: a client's first wake-up comes within one period (the
#: slowest tier's is 2), its second one period later, so every client
#: wakes at least twice by t = 4; the other methods get 2 rounds (the
#: round engines are paced by that slowest period) or 4 time units
DFL_TIME = 4.0
DFL_METHODS = ("fedlay", "fedlay-noconf", "fedlay-sync", "fedavg", "gaia", "chord",
               "dfl-dds")
#: final models of fedlay, card against CPU, as a share of max|p|: cuBLAS
#: and the CPU round their matmuls differently, and the difference grows
#: over the run's local steps.  Set from the readings: 1.70e-05 in both
#: H100 runs of this phase (NVIDIA H100 80GB HBM3, 700 W), so about 6x room.
DFL_CARD_TOL = 1e-4
#: the first SGD step's gradient of each task, card against the CPU in
#: f64 from the same vector and batch, as a share of each leaf's max|g|:
#: the card's f32 path read at most 5.7e-07 over the three tasks' leaves
#: and the CPU's f32 7.0e-07, while the card with TF32 products and
#: convolutions (``first_gradient``'s contrast) read 4.0e-04 to 4.6e-04
#: at the worst leaf of each task (NVIDIA H100 80GB HBM3, 700.00 W).  So
#: this limit holds the card to full f32 with 17x room, and every run
#: checks that TF32 would fail it.
DFL_GRAD_TOL = 1e-5
#: one whole local_train (4 steps), card against CPU in f32 from the same
#: vector, as a share of max|p|: read 3.55e-08 (MLP) and 3.88e-08 (LSTM)
#: (NVIDIA H100 80GB HBM3, 700.00 W).  Not the CNN's (``step_tol`` None
#: in ``DFL_TASKS``): there a later step meets max-pool windows whose two
#: best inputs lie within f32 rounding, and each side of such a tie is a
#: different result.  cuDNN's weight gradient (``wgrad_alg0_engine``)
#: sums with atomics, so the card's side varies from run to run: two card
#: runs of one process read 2.03e-04 apart, the card 2.03e-04 and the
#: CPU's f32 5.93e-05 off an f64 referee, where its first step's gradient
#: read within 3.7e-07.  The CNN's precision is held by ``DFL_GRAD_TOL``.
DFL_STEP_TOL = 1e-6
#: the CNN's and the LSTM's methods: Table III's columns but chord, cut to
#: make room for the ``churn`` phase in the script's time limit (the MLP
#: keeps it in ``DFL_METHODS``; the CPU tests run chord for both tasks)
DFL_TASK_METHODS = ("fedlay", "fedavg", "gaia", "dfl-dds")


def check_weighted_mix(torch):
    """weighted_mix against weighted_mix_ref on the card, bit for bit:
    f32 and bf16, K in {1, 2, 7, 15, 16, 17, 100, 513} (around the
    groups of 8 rows, and one K over the host weights carried by value),
    N in {1, 127, 50,890, 2^24 + 3}
    (K 513 up to 50,890), with no mask, a mask, and every model masked
    (zeros); the same weights and mask from the host, bit for bit with the
    device's; the same models as a row-strided view (on the 16-byte grid
    when N + 5 rounds so, narrower loads otherwise), and an ``out`` that is
    a row of that view.  Both sum from zero in the order k = 0 … K−1 with
    each product rounded to f32 (tolerance 0)."""
    from repro_torch.kernels.ref import weighted_mix_ref
    from repro_torch.kernels.weighted_mix import weighted_mix
    gen = torch.Generator(device="cuda").manual_seed(17)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for K in (1, 2, 7, 15, 16, 17, 100, 513):
            for N in (1, 127, 50_890, 2 ** 24 + 3):
                if K > 100 and N > 50_890:
                    continue
                pad = 8 - N % 8 if N % 2 else 5
                big = torch.randn((K, N + pad), generator=gen, device="cuda").to(dtype)
                view = big[:, :N]
                models = view.contiguous()
                w = torch.rand((K,), generator=gen, device="cuda")
                some = (torch.rand((K,), generator=gen, device="cuda") < 0.5).float()
                some[0] = 1.0
                for mask in (None, some, torch.zeros_like(some)):
                    out = weighted_mix(models, w, mask=mask)
                    ref = weighted_mix_ref(models, w, mask)
                    host = weighted_mix(models, w.cpu(),
                                        mask=None if mask is None else mask.cpu())
                    check(out.dtype == dtype and torch.equal(bits(out), bits(ref))
                          and torch.equal(bits(host), bits(out)),
                          f"weighted_mix differs at K {K}, N {N}, {dtype}, mask "
                          f"{None if mask is None else mask.tolist()[:4]}")
                    cases += 2
                check(not weighted_mix(models, w, mask=torch.zeros_like(some)).any(),
                      "an all-masked weighted_mix is not zeros")
                want = weighted_mix_ref(models, w)
                check(torch.equal(bits(weighted_mix(view, w)), bits(want)),
                      f"weighted_mix over a row-strided view differs at K {K}, N {N}")
                check(weighted_mix(view, w.cpu(), out=view[K // 2]).data_ptr()
                      == view[K // 2].data_ptr() and torch.equal(bits(view[K // 2]),
                                                                 bits(want)),
                      f"weighted_mix into a row of its input differs at K {K}, N {N}")
                cases += 2
                del big, view, models
    torch.cuda.synchronize()
    print(f"kernels: weighted_mix on {cases} cases (f32 and bf16, K 1 to 513, N 1 to "
          f"2^24 + 3, device and host weights, masked, all masked, row-strided, out a "
          f"row of the input): bit for bit with its plain version (tolerance 0)")


def mlp_work(task) -> tuple:
    """The MLP's local step and evaluation device bytes (``DFL_TASKS``)."""
    n = task._xte.shape[0]
    work = (8 * 4 * task.num_params
            + 4 * task.batch * (task.d_in + 2 * task.hidden + 2 * task.k)
            + 4 * n * (3 * task.hidden + task.k))
    return work, "8 N x 4, a batch's activations, one evaluation"


def cnn_work(task) -> tuple:
    """The CNN's (``DFL_TASKS``).  A max pool's output is counted at 12
    bytes an element, with its int64 argmax."""
    b, c, side, n = task.batch, task.ch, task._xte.shape[-1], task._xte.shape[0]
    q, r = side // 2, side // 4
    # forward over the batch: x, conv1 (ReLU in place), pool1 + argmax,
    # conv2, pool2 + argmax, the NHWC copy, logits; as much again back
    step = 2 * 4 * b * (3 * side * side + c * side * side + 3 * c * q * q
                        + 2 * c * q * q + 3 * 2 * c * r * r + task.d_flat + task.k)
    # the evaluation peaks at conv1's map beside pool1 and its argmax
    evaluation = 4 * n * (c * side * side + 3 * c * q * q + task.d_flat + 2 * task.k)
    return (8 * 4 * task.num_params + step + evaluation,
            "8 N x 4, a batch's maps x 2, the test set's conv1 map and pool1")


def lstm_work(task) -> tuple:
    """The LSTM's (``DFL_TASKS``)."""
    b, e, h, v, s = task.batch, task.EMBED, task.hidden, task.vocab, task.seq
    n = task._xte.shape[0]
    # forward over the batch: the window, the embeddings, e·wx and + b,
    # each step's z, h·wh, gates and states, the stacked h, logits and
    # log-probabilities; as much again back
    step = 8 * b * (s + 1) + 2 * 4 * b * s * (e + 2 * 4 * h + 2 * 4 * h + 9 * h + h + 2 * v)
    evaluation = 4 * n * s * (e + 2 * 4 * h + 2 * h + 2 * v) + 4 * n * (2 * 4 * h + 9 * h)
    return (8 * 4 * task.num_params + step + evaluation,
            "8 N x 4, a batch's steps x 2, one evaluation")


#: the dfl phase's tasks, one entry each: N at the phase's widths and the
#: task's defaults; ``work``, one local step's and one evaluation's device
#: bytes beyond what the task keeps resident (its data), reckoned from its
#: shapes (the step's 8 flat vectors: its input copy, the gradient, the
#: per-slice gradients autograd scatters into flat buffers, lr·grad and
#: the update; its batch's activations and their gradients; one
#: evaluation's activations at their largest); ``conv``, whether cuDNN's
#: convolution workspace joins the reckoning (``conv_workspace``); and the
#: limits of ``dfl_task_runs``' card-against-CPU checks.
#:
#: fedlay's final models, card against CPU, as a share of max|p| (``tol``)
#: and its trace accuracies in predictions (``flips``).  The MLP's: see
#: ``DFL_CARD_TOL``.  The CNN's run carries a rounding-size difference far
#: (a max pool's winner or a ReLU's side flips, and the SGD steps part
#: from there): read 11, 6 and 9 of 1000 predictions and 2.12e-03,
#: 1.96e-03 and 2.27e-03 x max|p| against the CPU, and 10 and 2.01e-03
#: between two card runs whose initial vectors differ by 1e-7 x N(0, 1);
#: its limits have about 4x room.  The LSTM's run is smooth: 0
#: predictions and 1.16e-07 x max|p| read, limit 1e-5.
#: Its CPU run takes one intra-op thread (``cpu_threads``): its ops are
#: small, and more threads only add their handoffs (NVIDIA H100 80GB HBM3,
#: 700.00 W, for all these readings).
DFL_TASKS = {
    "MLPTask": dict(N=50_890, work=mlp_work, tol=DFL_CARD_TOL),
    "CNNTask": dict(N=25_578, work=cnn_work, conv=True, flips=40, tol=1e-2,
                    step_tol=None),
    "LSTMTask": dict(N=27_936, work=lstm_work, flips=2, tol=1e-5, cpu_threads=1),
}


def conv_workspace(torch, task) -> int:
    """cuDNN's convolution workspace, which passes through the caching
    allocator and so lands in the peak: the most that one of the CNN's
    convolutions, run alone at the phase's shapes (each layer's forward
    over the test set, as an evaluation runs it, and its forward and
    backward over a batch, as a local step runs them), allocates beyond
    the tensors it leaves behind.  Measured so, as no API reports the
    size of the workspace cuDNN's heuristics pick."""
    import torch.nn.functional as F
    t = task.unflatten(task.init_params(0))
    side, most = task._xte.shape[-1], 0
    for i, (conv, bias) in enumerate((("c1", "b1"), ("c2", "b2"))):
        w = t[conv].permute(3, 2, 0, 1).detach().requires_grad_(True)
        bb = t[bias].detach().requires_grad_(True)
        hw = side >> i
        for rows, train in ((task._xte.shape[0], False), (task.batch, True)):
            x = torch.randn((rows, w.shape[1], hw, hw), device="cuda",
                            requires_grad=train and i > 0)
            g = torch.randn((rows, w.shape[0], hw, hw), device="cuda") if train else None
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with torch.set_grad_enabled(train):
                y = F.conv2d(x, w, bb, padding=1)
                if train:
                    y.backward(g)
            torch.cuda.synchronize()
            kept = torch.cuda.memory_allocated() - base     # y and the gradients
            most = max(most, torch.cuda.max_memory_allocated() - base - kept)
            del x, g, y
            w.grad = bb.grad = None
    return most


def dfl_reckoned(task, method, n, N, workspace=0) -> tuple:
    """The device bytes a run of ``method`` adds to what is allocated
    before it: the engine's buffers, plus the task's local step and
    evaluation (its ``DFL_TASKS`` entry's ``work``) and cuDNN's workspace
    (``conv_workspace``).  Returns (bytes, what)."""
    from repro_torch.core.dfl import resolve_method
    spec = resolve_method(method)
    f = 4 * N
    if spec.engine == "gossip":
        topo = spec.topology(n, DFL_SPACES)
        D = max(topo.degrees().values())
        engine, what = n * (1 + D) * f + f, f"n (1 + D) N x 4 with D = {D}, + N x 4"
    elif spec.engine == "fedavg":
        engine, what = n * f + f, "n N x 4 local models + N x 4"
    elif spec.engine == "gaia":
        engine, what = n * f + 4 * f, "n N x 4 local models + 4 N x 4 regions"
    else:
        engine, what = 2 * n * f + f, "2 n N x 4 client buffers + N x 4"
    work, done = DFL_TASKS[type(task).__name__]["work"](task)
    what = f"{what}; {done}"
    if workspace:
        what += f"; cuDNN's workspace {workspace / 1e6:.3f} MB"
    return engine + work + workspace, what


def first_gradient(torch, task, cpu_task, p0) -> dict:
    """The gradient of a local_train's first SGD step (client 0, seed 0)
    from the same vector and batch, before any rounding difference can
    move a max pool's or a ReLU's winner: on the card, on the CPU in f32,
    and on the card with TF32 products and convolutions (turned on for
    this call only, as the contrast), each against the CPU in f64 (the
    referee).  Returns, per leaf, those three largest differences, each
    as a share of the leaf's max|g|."""
    import numpy as np
    idx = task.partition.client_indices[0]
    take = np.random.default_rng(0).choice(idx, size=min(task.batch, len(idx)),
                                           replace=False)

    def grad(t, dtype):
        x, y = t._batch_of(take)
        x = x.to(dtype) if x.is_floating_point() else x
        p = p0.detach().to(device=t.device, dtype=dtype).requires_grad_(True)
        (g,) = torch.autograd.grad(t._loss(t.unflatten(p), x, y), p)
        return g.detach().cpu().double()

    ref = grad(cpu_task, torch.float64)
    got = [grad(task, torch.float32), grad(cpu_task, torch.float32)]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        got.append(grad(task, torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    for leaf, off, shape in task._layout:
        sl = slice(off, off + int(np.prod(shape)))
        top = ref[sl].abs().max().item() or 1.0
        out[leaf] = tuple((g[sl] - ref[sl]).abs().max().item() / top for g in got)
    return out


def local_train_f64(torch, cpu_task, p0):
    """local_train on the CPU in f64, with its draws: the referee."""
    import numpy as np
    p = p0.detach().cpu().double()
    idx = cpu_task.partition.client_indices[0]
    rng = np.random.default_rng(0)
    for _ in range(cpu_task.local_steps):
        take = rng.choice(idx, size=min(cpu_task.batch, len(idx)), replace=False)
        x, y = cpu_task._batch_of(take)
        x = x.double() if x.is_floating_point() else x
        p = p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(cpu_task._loss(cpu_task.unflatten(p), x, y), p)
        p = p.detach() - cpu_task.lr * g
    return p


def dfl_task_runs(torch, card, task, cpu_task, methods, kw) -> int:
    """Engine.run over ``task`` for each of ``methods``, with its checks
    and the limits of its ``DFL_TASKS`` entry: first its N, and one
    local_train and one evaluation on the card against the same on
    ``cpu_task`` from the same vector (within ``DFL_STEP_TOL`` x max|p|,
    the same correct predictions); each aggregation one weighted_mix
    launch (against the engine's count); each run's peak against its
    reckoning; fedlay's mean accuracy rising; fedlay on the card against
    the same call over ``cpu_task`` (counters and trace times equal,
    accuracies within ``flips`` predictions, final models within ``tol``
    x max|p|; with ``cpu_threads`` intra-op threads there).  The fedlay
    run carries a telemetry bus, whose spans split its host time.
    Returns the launches of the methods' runs."""
    import numpy as np
    from repro_torch.core.dfl import Engine
    from repro_torch.kernels.weighted_mix import weighted_mix
    from repro_torch.obs.events import Telemetry
    name, n, N = type(task).__name__, task.num_clients, task.num_params
    spec = DFL_TASKS[name]
    check(N == spec["N"], f"{name} has {N} parameters, not {spec['N']}")
    predictions = cpu_task._yte.numel()
    # a warm-up local step and evaluation, so that what is allocated before
    # each run holds cuBLAS's workspaces: one for each thread that runs
    # products, the caller's and autograd's; it is also the one-step check
    before = torch.cuda.memory_allocated()
    p0 = task.init_params(0)
    got = task.local_train(p0, 0, seed=0)
    acc = task.evaluate(got)
    torch.cuda.synchronize()
    print(f"dfl: {name}: a warm-up local step and evaluation keep "
          f"{(torch.cuda.memory_allocated() - before) / 2 ** 20:.3f} MiB allocated")
    grads = first_gradient(torch, task, cpu_task, p0)
    worst = max(g[0] for g in grads.values())
    tf32 = max(g[2] for g in grads.values())
    check(worst <= DFL_GRAD_TOL < tf32,
          f"{name}: the first step's gradient on the card is {worst:.2e} of a leaf's "
          f"max|g| off the f64 referee's, with TF32 {tf32:.2e}")
    print(f"dfl: {name}: the first SGD step's gradient against the CPU in f64 from the "
          f"same vector and batch, per leaf as a share of its max|g|, card (limit "
          f"{DFL_GRAD_TOL:g}) / CPU in f32 / card with TF32: " + "; ".join(
              f"{leaf} {a:.2e} / {b:.2e} / {c:.2e}" for leaf, (a, b, c) in grads.items()))
    want = cpu_task.local_train(p0.cpu(), 0, seed=0)
    referee = local_train_f64(torch, cpu_task, p0)
    repeat = task.local_train(p0, 0, seed=0).cpu()
    scale = want.abs().max().item()

    def share(a, b):
        return (a.double() - b.double()).abs().max().item() / scale
    err = share(got.cpu(), want)
    right, cpu_right = round(acc * predictions), round(cpu_task.evaluate(got.cpu()) * predictions)
    step_tol = spec.get("step_tol", DFL_STEP_TOL)
    check((step_tol is None or err <= step_tol) and right == cpu_right,
          f"{name}: one local_train on the card is {err:.2e} x max|p| off the CPU's, and "
          f"its evaluation counts {right} right against {cpu_right}")
    print(f"dfl: {name}: one local_train from the same vector, as a share of max|p|: card "
          f"against CPU {err:.2e} (limit {step_tol or 'none: max-pool near-ties'}); "
          f"against the CPU in f64, card {share(got.cpu(), referee):.2e}, CPU in f32 "
          f"{share(want, referee):.2e}; a second card run {share(repeat, got.cpu()):.2e} "
          f"from the first; its evaluation {right} of {predictions} right on both")
    workspace = conv_workspace(torch, task) if spec.get("conv") else 0
    if workspace:
        print(f"dfl: {name}: cuDNN's convolution workspace, its largest over the "
              f"convolutions run alone at the phase's shapes: {workspace / 1e6:.3f} MB")
    launches, fed, bus = 0, None, Telemetry()
    for method in methods:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reckoned, what = dfl_reckoned(task, method, n, N, workspace)
        weighted_mix.launches = 0
        t0 = time.perf_counter()
        res = Engine().run(task, method, **kw,
                           **(dict(telemetry=bus) if method == "fedlay" else {}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        count = weighted_mix.launches
        peak = torch.cuda.max_memory_allocated() - base
        check(count == res.aggregations > 0,
              f"{name} {method}: weighted_mix launches {count} != the engine's "
              f"{res.aggregations} aggregations")
        check(peak <= reckoned * (1 + PEAK_MARGIN),
              f"{name} {method}: peak {peak} bytes over the reckoned {reckoned} x "
              f"{1 + PEAK_MARGIN}")
        launches += count
        first, last = res.trace[0].mean_acc, res.trace[-1].mean_acc
        print(f"dfl: {name}: {method}: {wall:.2f} s wall; mean accuracy {first:.4f} -> "
              f"{last:.4f} at t = {res.trace[-1].time:g}; {res.messages_per_client:.2f} "
              f"messages a client, {res.suppressed_sends} suppressed sends, "
              f"{res.local_steps_per_client:.2f} local trainings a client; "
              f"weighted_mix launches {count} = {res.aggregations} aggregations; peak "
              f"{peak / 1e6:.3f} MB over the {base / 1e6:.3f} MB before, reckoned "
              f"{reckoned / 1e6:.3f} MB ({what}) ({card})")
        if method == "fedlay":
            check(last > first, f"{name}: fedlay's mean accuracy {last} did not rise "
                                f"above {first}")
            res.final_params = [p.cpu() for p in res.final_params]
            fed, fed_ms = res, wall * 1e3
        del res

    # where the fedlay run's host time went (host spans of the engine)
    parts = {span: bus.histograms[f"engine.{span}.ms"] for span in
             ("local_train", "fingerprint", "aggregate", "evaluate")}
    spent = sum(h.total for h in parts.values())
    print(f"breakdown: {name}: the fedlay run, {fed_ms:.1f} ms host: " + "; ".join(
        f"{span} {h.total:.1f} ms ({100 * h.total / fed_ms:.1f} %, {h.count} x "
        f"{h.mean:.3f} ms)" for span, h in parts.items())
        + f"; the rest (sends, heap, weights) {fed_ms - spent:.1f} ms ({card})")
    agg = parts["aggregate"]
    print(f"dfl: {name}: engine.aggregate mean {agg.mean:.4f} ms a call (min "
          f"{agg.min:.4f}, max {agg.max:.4f}) over {agg.count} calls of the fedlay "
          f"run ({card})")

    def apart(a, b):
        """The largest difference of two fedlay runs' trace accuracies, in
        predictions, and of their final models, as a share of max|p|."""
        flipped = max(np.abs(x.accs - y.accs).max() for x, y in zip(a.trace, b.trace))
        top = max(p.abs().max().item() for p in b.final_params)
        off = max((p.cpu() - q).abs().max().item()
                  for p, q in zip(a.final_params, b.final_params))
        return round(flipped * predictions), off / top

    # fedlay on the CPU: the same call, seed and initial vector
    threads = torch.get_num_threads()
    cpu_threads = spec.get("cpu_threads", threads)
    torch.set_num_threads(cpu_threads)
    t0 = time.perf_counter()
    try:
        ref = Engine().run(cpu_task, "fedlay", **kw)
    finally:
        torch.set_num_threads(threads)
    cpu_wall = time.perf_counter() - t0
    for field in ("comm_bytes_per_client", "messages_per_client", "suppressed_sends",
                  "local_steps_per_client", "aggregations"):
        check(getattr(fed, field) == getattr(ref, field),
              f"{name}: fedlay card and CPU differ in {field}: {getattr(fed, field)} / "
              f"{getattr(ref, field)}")
    check([r.time for r in fed.trace] == [r.time for r in ref.trace],
          f"{name}: fedlay card and CPU trace times differ")
    flipped, off = apart(fed, ref)
    flips, tol = spec.get("flips", 2), spec["tol"]
    check(flipped <= flips and off <= tol,
          f"{name}: fedlay card and CPU differ by {flipped} predictions and "
          f"{off:.3e} x max|p|")
    print(f"dfl: {name}: fedlay card against CPU ({cpu_wall:.2f} s there, "
          f"{cpu_threads} threads): bytes, "
          f"messages, local steps, suppressed sends, aggregations and {len(fed.trace)} "
          f"trace times equal; accuracies within {flipped} of {predictions} predictions "
          f"(limit {flips}); final models within {off:.3e} x max|p| (limit {tol:g})")
    del fed, ref
    return launches


def local_train_breakdown(torch, task, card) -> None:
    """One local_train's host time against the device's busy time and its
    device launches, from the profiler."""
    p0 = task.init_params(0)
    counts = {}
    wall, kernels = profiled(torch, lambda: task.local_train(p0, 0, seed=0), counts=counts)
    busy, launches = sum(kernels.values()), sum(counts.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
    print(f"breakdown: {type(task).__name__}: one local_train ({task.local_steps} steps "
          f"of batch {task.batch}): host {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f} %), {launches} device launches "
          f"({launches / task.local_steps:.0f} a step, {1e3 * wall / launches:.1f} us of "
          f"host a launch); top kernels (ms): " + "; ".join(
              f"{k[:50]} {ms:.3f}" for k, ms in top) + f" ({card})")


def phase_dfl(torch, card):
    """The paper's DFL engine over its three tasks (Table III's columns),
    each aggregation one weighted_mix launch: Engine.run over MLPTask at
    its default width on MNIST's 28 x 28 input width (N = 50,890), 100
    clients, for fedlay, its two ablations and Table III's baselines;
    then over CNNTask at its defaults on CIFAR-10's 32 x 32 x 3 input
    width (N = 25,578, 100 clients x 3 label shards) and over LSTMTask at
    its defaults on 200 role streams of 1024 characters, two roles a
    client (N = 27,936, 100 clients), for Table III's five methods.  For
    each task: the first SGD step's gradient on the card against an f64
    referee and one local_train against the CPU's (``dfl_task_runs``),
    launches equal to the engine's aggregations, peak memory
    within its reckoning, fedlay's accuracy rising, fedlay on the card
    against the same call on the CPU, where a fedlay run's host time
    goes and the mean of its engine.aggregate span; for the CNN and the
    LSTM one local_train's host and device time and launches.  Then
    weighted_mix alone at each task's wake-up shape (the MLP's also with
    rows padded to 16 bytes) and at a bandwidth shape, with host weights
    (the engine's) and device weights, its load width, and the wrapper's
    wall time a call at the MLP's wake-up."""
    from repro_torch.core.baselines import fedlay
    from repro_torch.data import char_lm, cifar_like, mnist_like, shard_partition
    from repro_torch.kernels.ref import weighted_mix_ref
    from repro_torch.kernels.weighted_mix import weighted_mix
    from repro_torch.models.small import CNNTask, LSTMTask, MLPTask

    data = mnist_like(n_train=6000, n_test=1000, image=28, seed=0)
    part = shard_partition(data.y_train, num_clients=DFL_CLIENTS,
                           shards_per_client=DFL_SHARDS, seed=0)
    task = MLPTask(data, part, device="cuda")
    n, N = task.num_clients, task.num_params
    kw = dict(total_time=DFL_TIME, num_spaces=DFL_SPACES, seed=0)
    print(f"dfl: Engine.run over MLPTask (784-64-10, batch {task.batch}, "
          f"{task.local_steps} local steps, lr {task.lr}) on mnist_like(6000, 1000, "
          f"image 28), {n} clients x {DFL_SHARDS} label shards, L = {DFL_SPACES}, "
          f"capacity periods (base 1), total time {DFL_TIME}; N = {N} f32 "
          f"({4 * N / 1e3:.1f} KB)")
    launches = dfl_task_runs(torch, card, task, MLPTask(data, part, device="cpu"),
                             DFL_METHODS, dict(kw, model_bytes=4 * N))
    del task

    images = cifar_like(n_train=6000, n_test=1000, image=32, seed=0)
    part = shard_partition(images.y_train, num_clients=DFL_CLIENTS,
                           shards_per_client=DFL_SHARDS, seed=0)
    t0 = time.perf_counter()
    text = char_lm(num_roles=2 * DFL_CLIENTS, stream_len=1024, test_len=8192, vocab=32,
                   seed=0)
    text_s = time.perf_counter() - t0
    for task, cpu_task, said in (
            (CNNTask(images, part, device="cuda"), CNNTask(images, part, device="cpu"),
             "cifar_like(6000, 1000, image 32), 100 clients x 3 label shards"),
            (LSTMTask(text, DFL_CLIENTS, device="cuda"),
             LSTMTask(text, DFL_CLIENTS, device="cpu"),
             f"char_lm(200 roles, stream 1024, test 8192, vocab 32; made in "
             f"{text_s:.1f} s), two roles a client")):
        name, size = type(task).__name__, task.num_params
        print(f"dfl: Engine.run over {name} at its defaults (batch {task.batch}, "
              f"{task.local_steps} local steps, lr {task.lr}) on {said}, L = "
              f"{DFL_SPACES}, total time {DFL_TIME}; N = {size} f32 "
              f"({4 * size / 1e3:.1f} KB)")
        launches += dfl_task_runs(torch, card, task, cpu_task, DFL_TASK_METHODS,
                                  dict(kw, model_bytes=4 * size))
        local_train_breakdown(torch, task, card)
        del task, cpu_task
    gc.collect()

    # weighted_mix alone: each task's wake-up (1 + D, N) block as the engine
    # lays it out (the MLP's and the CNN's rows 8 bytes off the 16-byte
    # grid: 8-byte loads; the LSTM's on it: 16-byte loads), the MLP's with
    # rows padded to 16 bytes, and a bandwidth shape; each with the weights
    # from the host, as the engine passes them (carried in the launch), and
    # from the device
    from repro_torch.kernels.gather_mix import _sm_count
    from repro_torch.kernels.weighted_mix import launch_plan
    K = 1 + max(fedlay(n, DFL_SPACES).degrees().values())
    check((K, N) == (WAKE_K, WAKE_N), f"the wake-up is ({K}, {N}), not the "
                                      f"--weighted-mix turn's ({WAKE_K}, {WAKE_N})")
    gen = torch.Generator(device="cuda").manual_seed(23)
    timed = {}
    for label, (k, cols, width), reps, load in (
            ("wake-up", (K, N, N), 200, 8),
            ("padded wake-up", (K, N, -(-N // 4) * 4), 200, 16),
            ("CNNTask wake-up", (K, DFL_TASKS["CNNTask"]["N"], DFL_TASKS["CNNTask"]["N"]),
             200, 8),
            ("LSTMTask wake-up", (K, DFL_TASKS["LSTMTask"]["N"], DFL_TASKS["LSTMTask"]["N"]),
             200, 16),
            ("bandwidth", (7, 2 ** 26, 2 ** 26), 20, 16)):
        block = torch.randn((k, width), generator=gen, device="cuda")[:, :cols]
        w = torch.rand((k,), generator=gen, device="cuda")
        w /= w.sum()
        w_host = w.cpu()
        out = torch.empty(cols, device="cuda")
        ref = weighted_mix_ref(block, w)
        got = weighted_mix(block, w_host, out=out)
        check(torch.equal(bits(got), bits(ref))
              and torch.equal(bits(weighted_mix(block, w)), bits(ref)),
              f"weighted_mix differs at ({k}, {cols})")
        err = (got - ref).abs().max().item()
        plan = launch_plan(k, cols, 4, width, block.data_ptr(), out.data_ptr(),
                           _sm_count(0), True)
        check(plan.vec * 4 == load, f"weighted_mix at the {label} shape loads "
                                    f"{plan.vec * 4} bytes, not {load}")
        ms = device_ms(torch, [lambda: weighted_mix(block, w_host, out=out)], reps)
        dev_ms = device_ms(torch, [lambda: weighted_mix(block, w, out=out)], reps)
        plain_ms = device_ms(torch, [lambda: weighted_mix_ref(block, w)], max(1, reps // 10))
        lib_ms = device_ms(torch, [lambda: torch.matmul(w, block)], reps)
        t_b = (k + 1) * cols * 4 / HBM_BYTES_PER_S
        t_o = 2 * k * cols / F32_FLOPS_PER_S
        bound_ms, bound_by = max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")
        timed[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=lib_ms)
        print(f"dfl: weighted_mix f32 at the {label} shape K = {k}, N = {cols}, row "
              f"stride {width} ({plan.vec * 4}-byte loads, {plan.blocks} blocks of "
              f"{plan.threads}): bit for bit with its plain version, host and device "
              f"weights; device time per call: kernel {ms:.6f} ms with host weights "
              f"({100 * bound_ms / ms:.1f} % of the bound), {dev_ms:.6f} ms with device "
              f"weights, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}, "
              f"{(k + 1) * cols * 4 / 1e6:.3f} MB), torch.matmul(w, models) "
              f"{lib_ms:.6f} ms ({card})")
        if label == "wake-up":
            wall_host = host_ms(torch, lambda: weighted_mix(block, w_host, out=out), 1000)
            wall_dev = host_ms(torch, lambda: weighted_mix(block, w, out=out), 1000)
            print(f"dfl: weighted_mix wall time per call at the wake-up shape, 1000 calls "
                  f"back to back: {wall_host:.4f} ms with host weights, {wall_dev:.4f} ms "
                  f"with device weights ({card})")
        del block, out, ref, got
    main = timed["wake-up"]
    print(f"dfl: weighted_mix launches over the three tasks' card runs "
          f"({len(DFL_METHODS)} + 2 x {len(DFL_TASK_METHODS)} methods): {launches}")
    return {"name": "weighted_mix", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/weighted_mix.cu",
            "replaces": "src/repro/kernels/weighted_mix.py:88",
            "launches": launches, **main}


#: the DFL engine's wake-up as ``phase_dfl`` meets it: fedlay's 1 + 6
#: rows at L = 3 of the MLP's 50,890 f32, laid 50,890 floats apart
WAKE_K, WAKE_N = 7, 50_890


def weighted_mix_turn(torch, root: Path, card: str) -> None:
    """One turn of ``--weighted-mix ROOT``: the wrapper of the checkout
    at ROOT on the wake-up's block, bit for bit with that checkout's plain
    version; device ms a call (``device_ms``, 200 calls) and the wrapper's
    wall ms a call (``host_ms``, 1000 calls back to back), with device
    weights and, where that wrapper takes them, host weights; and the
    first call's wall time, which builds the kernel."""
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels.ref import weighted_mix_ref
    from repro_torch.kernels.weighted_mix import weighted_mix
    gen = torch.Generator(device="cuda").manual_seed(23)
    block = torch.randn((WAKE_K, WAKE_N), generator=gen, device="cuda")
    w = torch.rand((WAKE_K,), generator=gen, device="cuda")
    w /= w.sum()
    out = torch.empty(WAKE_N, device="cuda")
    ref = weighted_mix_ref(block, w)
    t0 = time.perf_counter()
    weighted_mix(block, w, out=out)
    torch.cuda.synchronize()
    said = [f"first call {time.perf_counter() - t0:.1f} s"]
    for kind, weights in (("host", w.cpu()), ("device", w)):
        try:
            got = weighted_mix(block, weights, out=out)
        except ValueError:
            said.append(f"{kind} weights refused")
            continue
        check(torch.equal(bits(got), bits(ref)), f"weighted_mix of {root} differs")
        call = lambda: weighted_mix(block, weights, out=out)  # noqa: E731
        said.append(f"{kind} weights: device {device_ms(torch, [call], 200):.6f} ms, "
                    f"wall {host_ms(torch, call, 1000):.6f} ms")
    print(f"weighted_mix turn {root} (K {WAKE_K}, N {WAKE_N}): " + "; ".join(said)
          + f" ({card})")


def main() -> int:
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs one NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--weighted-mix":
        weighted_mix_turn(torch, Path(sys.argv[2]).resolve(), card_line())
        return 0
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from repro_torch import resolve_device
    from repro_torch.kernels.build import SOURCES, build
    from repro_torch.launch.mesh import make_client_mesh

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
        if name in ("flash_decode", "weighted_mix", "gather_mix"):
            continue
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"build: {name}:", line.strip())
    report_flash_decode_build(logs["flash_decode"])
    report_weighted_mix_build(logs["weighted_mix"])
    report_gather_mix_build(logs["gather_mix"])

    # the one-rank client group the per-rank mixer runs over
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mesh = make_client_mesh(0, 1, f"tcp://127.0.0.1:{port}", device="cuda",
                            timeout_s=300)
    print(f"mesh: one-rank NCCL client group (torch.distributed "
          f"{torch.distributed.get_backend(mesh.group)}, world size {mesh.size})")
    try:
        if sys.argv[1:] == ["--front-step"]:
            return 0 if front_step_turns(torch, card, mesh) else 1
        if sys.argv[1:] == ["--churn"]:
            phase_churn(torch, card)
            return 0
        phase_kernels(torch, F, card)
        check_gather_mix(torch, card)
        check_wire_kernels(torch)
        check_dequant_accumulate(torch)
        check_ssd_scan(torch)
        check_weighted_mix(torch)
        phase_small(torch)
        small_train(torch)
        for codec in WIRE_CODECS_RUN:
            small_train(torch, codec)
        small_codec_rounds(torch)
        small_mesh_rounds(torch, mesh)
        serve_entry = phase_slice(torch, F, card)
        gc.collect()
        torch.cuda.empty_cache()
        ssm_entry = phase_ssm(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        train_entry = phase_train(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        wire = {}
        for codec in WIRE_CODECS_RUN:
            entries, _, _ = phase_wire(torch, card, codec)
            wire.update(entries)
            gc.collect()
            torch.cuda.empty_cache()
        mesh_entry = phase_mesh(torch, card, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as scratch:
            phase_front(torch, card, mesh, Path(scratch))
        gc.collect()
        torch.cuda.empty_cache()
        train_entry["launches"] += phase_churn(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        dfl_entry = phase_dfl(torch, card)
    finally:
        mesh.close()
    print(f"script: {time.perf_counter() - started:.1f} s, the build included")
    print(json.dumps({"kernels": [dfl_entry, serve_entry, train_entry] + [
        wire[k] for k in ("mix_accumulate", "quantize_block", "dequantize_block")]
        + [mesh_entry, wire["gather_mix_int8"], ssm_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
