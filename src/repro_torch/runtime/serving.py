"""Continuous-batching serving loop over a fixed-capacity request
:class:`~repro_torch.runtime.slots.SlotMap`: the port of
``repro/runtime/serving.py``.

The device data plane keeps one allocation forever: a (capacity,)
request axis, the per-layer KV cache of :func:`init_cache`, the per-slot
position vector and the token buffer are allocated once when the loop
is built.  Request churn is an in-place row write: an arriving prompt is
prefilled straight into its slot's rows of the cache (through views),
and a finished request's position is set to -1, which the whole decode
stack treats as an empty slot (zero attention output, position frozen).

Slot lifecycle
--------------
::

    pending ──admit──► slot s: prefill(prompt) ─► pos[s] = len(prompt)
                         │ decode ticks: pos[s] += 1, token appended
                         ▼
    retire (max_new reached, deadline passed, or pos[s] would overflow)
                         │
                         ▼  pos[s] = -1  (empty; SlotMap frees s)

``policy="continuous"`` admits whenever a slot is free;
``policy="static"`` admits only into an empty batch and then drains it.

Position overflow is guarded on the host: the loop keeps a host mirror
of every slot's position and retires a row before its next write would
pass ``cache_len``.

Telemetry: ``serve.*`` counters (submitted, admitted, completed, ticks,
decode_steps, evictions, reloads), occupancy and queue gauges, a
``serve.tick`` span, and one :class:`~repro_torch.obs.rounds.RoundRecord`
per tick on the ambient round ledger.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..models.convert import module_state
from ..models.model import (LanguageModel, cache_rows, decode_step,
                            init_cache, layer_plan, prefill)
from ..obs.events import get_telemetry
from ..obs.rounds import get_round_ledger
from .slots import SlotMap

_CLOCK = time.perf_counter


@dataclasses.dataclass
class Request:
    """One generation request moving through the serving loop.

    ``prompt`` is the token prefix; ``max_new`` the number of tokens to
    generate (the token sampled from the prefill logits is the first).
    The loop fills ``tokens`` and the ``perf_counter`` stamps:
    ``t_arrival`` when the request was queued, ``t_first`` at its first
    token, ``t_done`` at completion.

    Deadlines: ``max_ticks`` bounds how many ticks the request may hold
    a slot after admission; ``deadline_s`` is a wall-clock bound from
    ``t_arrival``.  A request over either is retired with
    ``evicted=True`` and counted in ``serve.evictions``."""

    rid: int
    prompt: np.ndarray
    max_new: int = 16
    arrival_tick: int = 0
    max_ticks: Optional[int] = None
    deadline_s: Optional[float] = None
    admit_tick: int = -1
    evicted: bool = False
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_arrival: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def done(self) -> bool:
        return self.t_done > 0.0


class ServeLoop:
    """Fixed-capacity continuous-batching decode loop (see module doc).

    Parameters
    ----------
    model : the :class:`LanguageModel` to serve, on its device.
    capacity : request slots (the batch axis).
    cache_len : per-slot KV slots; longer generations are retired.
    prompt_len : the width every prompt is padded to.
    policy : ``"continuous"`` or ``"static"``.
    """

    def __init__(self, model: LanguageModel, *, capacity: int,
                 cache_len: int, prompt_len: int, policy: str = "continuous"):
        cfg = model.cfg
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown policy {policy!r}")
        if prompt_len > cache_len:
            raise ValueError(f"prompt_len {prompt_len} > cache_len {cache_len}")
        if cfg.sliding_window and prompt_len > cfg.sliding_window:
            raise ValueError("padded prompts longer than the sliding window "
                             "are not servable (ragged ring prefill)")
        if any(k[0] == "mamba" for k in layer_plan(cfg)):
            raise ValueError("ServeLoop pads ragged prompts, which SSM "
                             "stacks cannot prefill; serve attention "
                             "models here")
        self.model = model
        self.capacity = capacity
        self.cache_len = cache_len
        self.prompt_len = prompt_len
        self.policy = policy
        dev = model.device

        self.slots = SlotMap(capacity)
        self.cache = init_cache(model, capacity, cache_len, per_slot_pos=True)
        self._tok = torch.zeros((capacity, 1), dtype=torch.int32, device=dev)
        self._prompt = torch.zeros((1, prompt_len), dtype=torch.int32,
                                   device=dev)
        self._length = torch.zeros((1,), dtype=torch.int32, device=dev)
        self._pos_host = np.full((capacity,), -1, np.int64)
        self.pending: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}
        self.completed: List[Request] = []
        self.tick_index = 0
        self._next_rid = 0

    # ---- request intake --------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new: int = 16,
               arrival_tick: int = 0, max_ticks: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Queue one request; returns its :class:`Request` handle."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError("prompt must be a non-empty 1-D token list")
        if prompt.size > self.prompt_len:
            raise ValueError(f"prompt length {prompt.size} > static "
                             f"prompt_len {self.prompt_len}")
        if max_ticks is not None and max_ticks < 1:
            raise ValueError("max_ticks must be >= 1")
        req = Request(rid=self._next_rid, prompt=prompt, max_new=max_new,
                      arrival_tick=arrival_tick, max_ticks=max_ticks,
                      deadline_s=deadline_s, t_arrival=_CLOCK())
        self._next_rid += 1
        self.pending.append(req)
        get_telemetry().count("serve.submitted")
        return req

    # ---- internals -------------------------------------------------------
    def _admit_one(self, req: Request) -> None:
        slot = self.slots.alloc(req.rid)
        padded = np.zeros((1, self.prompt_len), np.int32)
        padded[0, :req.prompt.size] = req.prompt
        self._prompt.copy_(torch.from_numpy(padded))
        self._length.fill_(req.prompt.size)
        # prefill straight into the slot's rows of the resident cache
        logits, _ = prefill(self.model, cache_rows(self.cache, slot, slot + 1),
                            self._prompt, lengths=self._length)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        self._tok[slot] = tok
        self._pos_host[slot] = req.prompt.size
        req.admit_tick = self.tick_index
        req.t_first = _CLOCK()
        req.tokens.append(int(tok[0]))
        self.active[slot] = req
        get_telemetry().count("serve.admitted")
        if req.max_new <= 1:
            self._retire(slot, req)

    def _retire(self, slot: int, req: Request) -> None:
        req.t_done = _CLOCK()
        self.slots.free(req.rid)
        self.cache["pos"][slot] = -1
        self._pos_host[slot] = -1
        del self.active[slot]
        self.completed.append(req)
        get_telemetry().count("serve.completed")

    # ---- the batching tick -----------------------------------------------
    def tick(self) -> int:
        """One batching tick: evictions, admissions, then one decode step
        for the whole slot axis.  Returns the number of live requests
        after the tick.  Emits one round-ledger record."""
        bus = get_telemetry()
        completed_before = len(self.completed)
        n_admit = 0
        n_evict = self._evict_overdue()
        allow = self.policy == "continuous" or len(self.slots) == 0
        with bus.span("serve.tick"):
            while allow and self.pending and self.slots.num_free > 0:
                self._admit_one(self.pending.popleft())
                n_admit += 1
            if self.active:
                logits, _ = decode_step(self.model, self.cache, self._tok)
                self._tok.copy_(torch.argmax(logits, dim=-1, keepdim=True))
                toks = self._tok[:, 0].cpu().numpy()
                bus.count("serve.decode_steps")
                self._pos_host[self._pos_host >= 0] += 1
                for slot, req in list(self.active.items()):
                    req.tokens.append(int(toks[slot]))
                    # host-side overflow guard: the next decode would
                    # write at pos == cache_len, so retire now
                    if (len(req.tokens) >= req.max_new
                            or self._pos_host[slot] >= self.cache_len):
                        self._retire(slot, req)
        self.tick_index += 1
        bus.count("serve.ticks")
        bus.gauge("serve.occupancy", len(self.slots))
        bus.gauge("serve.queue_depth", len(self.pending))
        ledger = get_round_ledger()
        if ledger is not None:
            ledger.record(round=self.tick_index, loop="serve",
                          num_alive=len(self.slots),
                          participating=len(self.slots),
                          admitted=n_admit,
                          completed=len(self.completed) - completed_before,
                          evicted=n_evict,
                          queue_depth=len(self.pending))
        return len(self.active)

    def _evict_overdue(self) -> int:
        """Retire active requests past their deadlines, before this
        tick's admissions, so an expired request yields its slot."""
        bus = get_telemetry()
        n = 0
        now = _CLOCK()
        for slot, req in list(self.active.items()):
            over_ticks = (req.max_ticks is not None
                          and self.tick_index - req.admit_tick
                          >= req.max_ticks)
            over_wall = (req.deadline_s is not None
                         and now - req.t_arrival >= req.deadline_s)
            if over_ticks or over_wall:
                req.evicted = True
                self._retire(slot, req)
                bus.count("serve.evictions")
                n += 1
        return n

    def run(self, max_ticks: int = 100_000) -> List[Request]:
        """Tick until every submitted request has completed (or
        ``max_ticks``).  Returns the completed requests."""
        t = 0
        while (self.pending or self.active) and t < max_ticks:
            self.tick()
            t += 1
        if self.pending or self.active:
            raise RuntimeError(f"serving did not drain in {max_ticks} ticks")
        return self.completed

    # ---- hot model reload ------------------------------------------------
    def reload(self, params: Mapping[str, torch.Tensor]) -> None:
        """Copy new weights (a state dict of the served model's shape)
        into the served model in place, between ticks; in-flight
        requests continue on the new weights."""
        self.model.load_state_dict(params, strict=True)
        get_telemetry().count("serve.reloads")

    def reload_from_flat(self, buf: torch.Tensor, spec, row: int = 0) -> None:
        """Hot-reload from the training loop's (B, N) flat buffer: lift
        client ``row`` as a parameter tree in the reference's layout
        (``spec.unravel_row``, views of the row) and copy it into the
        served model.  ``spec`` is the :class:`~repro_torch.dist.flat.FlatSpec`
        of the buffer."""
        tree = spec.unravel_row(buf[row])
        self.reload(module_state(self.model.cfg, tree))
