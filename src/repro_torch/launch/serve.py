"""Serving entry points of the port: batched greedy decode, and the
continuous-batching slot loop.  The counterpart of
``repro/launch/serve.py``, with the same flags plus ``--device``.

* ``--mode batch`` (default): prefill a fixed batch of prompts in one
  forward pass, then decode greedily.
* ``--mode slots``: drive :class:`repro_torch.runtime.serving.ServeLoop`
  over a trace of requests with random prompt and generation lengths.

  PYTHONPATH=src python -m repro_torch.launch.serve --batch 4 \
      --prompt-len 32 --gen 32 --arch tiny
  PYTHONPATH=src python -m repro_torch.launch.serve --mode slots \
      --capacity 8 --requests 32 --policy continuous

It runs on the GPU unless ``--device cpu`` is given.  A named ``--arch``
is served reduced (``reduce_for_smoke``), as in the reference; weights
are random, drawn from ``--seed``.  ``run_batch`` / ``run_slots`` take a
config and a model, so a caller can serve a model at full size.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import REGISTRY, reduce_for_smoke, tiny_lm
from ..models.model import LanguageModel, decode_step, init_cache, prefill


def _check_tokens(gen_tokens: torch.Tensor, vocab: int) -> None:
    """Output-validity gate: every generated token lies in the vocab."""
    if bool((gen_tokens < 0).any()) or bool((gen_tokens >= vocab).any()):
        raise RuntimeError(
            f"generated tokens escaped the vocab [0, {vocab}): "
            f"min={int(gen_tokens.min())} max={int(gen_tokens.max())}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_batch(cfg, model: LanguageModel, args, rng) -> dict:
    """Prefill ``args.batch`` random prompts of ``args.prompt_len`` in one
    pass, then decode ``args.gen`` tokens greedily.  Prints and returns
    the timings."""
    dev = model.device
    B = args.batch
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(B, args.prompt_len)),
        dtype=torch.int32, device=dev)
    cache = init_cache(model, B, args.prompt_len + args.gen)

    t0 = time.perf_counter()
    logits, cache = prefill(model, cache, prompts)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    # every sampled token counts, including the one from the prefill
    t0 = time.perf_counter()
    tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    out = [tok]
    for _ in range(args.gen - 1):
        logits, cache = decode_step(model, cache, tok)
        tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
        out.append(tok)
    _sync(dev)
    gen_s = time.perf_counter() - t0

    gen_tokens = torch.cat(out, dim=1)
    tok_s = B * args.gen / max(gen_s, 1e-9)
    print(f"prefill: {args.prompt_len} tokens/row in one pass, "
          f"{prefill_s:.3f}s; decode: {tok_s:.1f} tok/s")
    print("sample:", gen_tokens[0, :16].tolist())
    _check_tokens(gen_tokens, cfg.vocab_size)
    return {"prefill_s": prefill_s, "decode_s": gen_s, "tok_s": tok_s}


def run_slots(cfg, model: LanguageModel, args, rng) -> dict:
    """Serve ``args.requests`` requests, with prompt lengths drawn from
    [1, prompt_len] and generation lengths from [1, gen], through a
    ``ServeLoop`` of ``args.capacity`` slots.  Prints and returns the
    results, with the loop under ``"loop"``."""
    from ..obs.events import telemetry
    from ..obs.rounds import round_ledger
    from ..runtime.serving import ServeLoop

    with telemetry() as bus, round_ledger() as ledger:
        loop = ServeLoop(model, capacity=args.capacity,
                         cache_len=args.prompt_len + args.gen,
                         prompt_len=args.prompt_len, policy=args.policy)
        for _ in range(args.requests):
            plen = int(rng.integers(1, args.prompt_len + 1))
            loop.submit(rng.integers(0, cfg.vocab_size, plen),
                        max_new=int(rng.integers(1, args.gen + 1)))
        t0 = time.perf_counter()
        done = loop.run()
        _sync(model.device)
        wall = time.perf_counter() - t0
    lat = sorted(r.latency_s for r in done)
    toks = sum(len(r.tokens) for r in done)
    for r in done:
        _check_tokens(torch.as_tensor(r.tokens), cfg.vocab_size)
    res = {"requests": len(done), "tokens": toks, "wall_s": wall,
           "tok_s": toks / wall,
           "p50_ms": lat[len(lat) // 2] * 1e3,
           "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3,
           "ledger": ledger.summary(), "counters": bus.snapshot(),
           "loop": loop}
    print(f"{args.policy}: {len(done)} requests in {wall:.3f}s "
          f"({len(done) / wall:.1f} req/s, {res['tok_s']:.1f} tok/s), "
          f"p50 {res['p50_ms']:.1f}ms p99 {res['p99_ms']:.1f}ms")
    print("ledger:", res["ledger"])
    print("counters:", res["counters"])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tiny",
                    help="'tiny' or any assigned arch id (reduced variant)")
    ap.add_argument("--mode", choices=("batch", "slots"), default="batch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=8,
                    help="request slots (slots mode)")
    ap.add_argument("--requests", type=int, default=32,
                    help="trace length (slots mode)")
    ap.add_argument("--policy", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = tiny_lm() if args.arch == "tiny" else reduce_for_smoke(REGISTRY[args.arch])
    print(f"serving {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} on {device}")
    model = LanguageModel(
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    if args.mode == "slots":
        run_slots(cfg, model, args, rng)
    else:
        run_batch(cfg, model, args, rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
