"""DFL execution engines (paper §IV) behind one registry front door, with
the client models on the device.

The port of ``repro/core/dfl.py``.  A method is a :class:`MethodSpec` —
engine kind, overlay topology factory, aggregation mode (MEP confidence
weights vs simple average), and pacing (per-client async periods vs
slowest-client sync rounds) — looked up in :data:`METHOD_REGISTRY` and
executed by :meth:`Engine.run`, the single entry point.  Ablation
variants compose as name suffixes in either order:
``"fedlay-noconf-sync"`` ≡ ``"fedlay-sync-noconf"``.

Registered methods (paper §IV-A4): ``fedlay`` (DFL over the FedLay
overlay, MEP confidence-weighted aggregation, asynchronous per-client
periods), ``fedavg`` (centralized FL, dataset-size-weighted global
average each round), ``gaia`` (a server per geo region, complete graph
across region servers, simple averaging), ``dfl-dds`` (topology-free
DFL between nearby mobile nodes), ``chord`` / ``ring`` / every other
registered topology (gossip over that overlay), each with ``-sync`` and
``-noconf``.

**On the device.**  A task's flat vectors are 1-D f32 tensors on its
device (:mod:`repro_torch.models.small`).  Client models are rows of one
preallocated tensor, and every aggregation is one
:func:`repro_torch.kernels.weighted_mix.weighted_mix` launch, which on a
CUDA tensor is the hand-written kernel:

* the gossip wake-up of client u over its own model and the models it
  has received: one (n, 1 + D, N) buffer, D the largest degree, holds
  client u's model in row ``[u, 0]`` and, in row ``[u, 1 + j]``, the
  latest model received from its j-th neighbour (sorted ids); a send is
  an in-place row copy, and slots not yet received hold zeros and get
  weight 0, so the launch reads ``buffer[u]`` as it lies and writes the
  result into row ``[u, 0]``;
* FedAvg's average over the (n, N) buffer of local models;
* Gaia's mean of each region's rows (a row-strided view of the local
  models) and then across the (R, N) region buffer;
* DFL-DDS's mean of each client's neighbourhood: the (n, N) client
  buffer with uniform weights and the neighbourhood as ``mask``.

The engine counts its aggregations (:attr:`RunResult.aggregations`), one
launch each.  Their weights (and DFL-DDS's mask) stay on the host as f32
tensors, and the kernel carries them in its launch's parameters, so an
aggregation copies nothing to the device.  The host keeps the event
heap, the numpy RNG, the link periods and the fingerprint tables, and
draws from the RNG in the reference's order, so one ``seed`` gives the
reference's event sequence and ``local_train`` seeds.

**Two parity facts, stated, not faults.**

* Under NumPy 2 the reference's ``w[0] * params[u]`` promotes to float64
  (the weights are a float64 array), so its aggregate is float64 and is
  rounded to f32 only at the next ``local_train``
  (``repro/models/small.py:37``); FedAvg's global model stays float64.
  The port rounds the weights to f32 and accumulates in f32 in the
  kernel.
* The reference sums the received models in inbox insertion order; the
  port sums them in slot order.  The weights themselves are computed on
  the host from the senders in insertion order, as the reference does,
  so they are the same float64 numbers.

The reference's deprecated ``run_method`` shim is not ported: nothing in
the port calls it.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from contextlib import ExitStack
from typing import (Any, Callable, Dict, List, Mapping, Optional, Protocol,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from ..kernels.weighted_mix import weighted_mix
from ..obs.events import get_telemetry
from ..obs.events import telemetry as telemetry_scope
from ..obs.rounds import get_round_ledger
from ..obs.rounds import round_ledger as ledger_scope
from .baselines import TOPOLOGY_REGISTRY
from .mep import (ClientProfile, FingerprintTable, aggregation_weights,
                  link_period, model_fingerprint)
from .topology import Topology


# --------------------------------------------------------------------------
# Task protocol
# --------------------------------------------------------------------------

class Task(Protocol):
    """A federated ML task: local data lives inside the task, addressed by
    client id, so the engine never sees raw data (as in real FL).  Flat
    vectors are 1-D f32 tensors on the task's device."""

    num_clients: int

    def init_params(self, seed: int) -> torch.Tensor: ...
    def local_train(self, params: torch.Tensor, client: int, seed: int) -> torch.Tensor: ...
    def evaluate(self, params: torch.Tensor) -> float: ...       # test accuracy
    def label_histogram(self, client: int) -> np.ndarray: ...
    def train_cost(self, client: int) -> float: ...              # relative compute


@dataclasses.dataclass
class TraceRow:
    time: float
    mean_acc: float
    min_acc: float
    max_acc: float
    accs: Optional[np.ndarray] = None


@dataclasses.dataclass
class RunResult:
    method: str
    trace: List[TraceRow]
    comm_bytes_per_client: float
    messages_per_client: float
    suppressed_sends: int
    local_steps_per_client: float
    final_params: List[torch.Tensor]
    #: weighted_mix calls the run made, one kernel launch each on the card
    aggregations: int = 0

    @property
    def final_mean_acc(self) -> float:
        return self.trace[-1].mean_acc if self.trace else 0.0


def make_profiles(task: Task, periods: Sequence[float]) -> Dict[int, ClientProfile]:
    return {
        i: ClientProfile(client_id=i, period=float(periods[i]),
                         label_histogram=task.label_histogram(i))
        for i in range(task.num_clients)
    }


def capacity_periods(n: int, base_period: float, seed: int = 0,
                     fractions: Tuple[float, float, float] = (0.2, 0.6, 0.2)) -> np.ndarray:
    """The paper's 3-tier client heterogeneity: 20% high (2/3·T),
    60% medium (T), 20% low (2·T)."""
    rng = np.random.default_rng(seed)
    tiers = rng.choice(3, size=n, p=list(fractions))
    mult = np.array([2.0 / 3.0, 1.0, 2.0])[tiers]
    return base_period * mult


# --------------------------------------------------------------------------
# Method specs + registry
# --------------------------------------------------------------------------

#: Topology factory: (num_clients, num_spaces) -> Topology.  Baseline
#: overlays ignore num_spaces; a pre-built Topology is also accepted.
TopologyFactory = Callable[[int, int], Topology]


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """Everything the engine needs to run one DFL method.

    ``engine`` selects the event loop: ``"gossip"`` (asynchronous
    overlay gossip — FedLay and every topology baseline) or one of the
    round-paced engines (``"fedavg"``, ``"gaia"``, ``"dfl-dds"``), which
    are inherently synchronous and simple-averaging, so ``aggregation``
    and ``pacing`` only steer the gossip engine.
    """

    name: str
    engine: str = "gossip"
    topology: Optional[Union[Topology, TopologyFactory]] = None
    aggregation: str = "confidence"        # "confidence" | "simple"
    pacing: str = "async"                  # "async" | "sync"
    options: Tuple[Tuple[str, Any], ...] = ()

    def variant(self, aggregation: Optional[str] = None,
                pacing: Optional[str] = None) -> "MethodSpec":
        """The ablation variant with its canonical suffixed name."""
        agg = aggregation or self.aggregation
        pace = pacing or self.pacing
        name = (self.name + ("-noconf" if agg == "simple" and
                             self.aggregation != "simple" else "")
                + ("-sync" if pace == "sync" and
                   self.pacing != "sync" else ""))
        return dataclasses.replace(self, name=name, aggregation=agg,
                                   pacing=pace)


METHOD_REGISTRY: Dict[str, MethodSpec] = {}


def register_method(spec: MethodSpec) -> MethodSpec:
    METHOD_REGISTRY[spec.name] = spec
    return spec


def resolve_method(method: str) -> MethodSpec:
    """Look up a method name, honoring ``-sync`` / ``-noconf`` suffixes
    in either order (``fedlay-noconf-sync`` ≡ ``fedlay-sync-noconf``)."""
    base, pacing, aggregation = method, None, None
    stripped = True
    while stripped:
        stripped = False
        if base.endswith("-sync"):
            base, pacing, stripped = base[:-len("-sync")], "sync", True
        elif base.endswith("-noconf"):
            base, aggregation, stripped = base[:-len("-noconf")], "simple", True
    spec = METHOD_REGISTRY.get(base)
    if spec is None and base in TOPOLOGY_REGISTRY:
        # call-time fallback: overlays added to TOPOLOGY_REGISTRY after
        # this module imported are still runnable as gossip methods
        factory = TOPOLOGY_REGISTRY[base]
        spec = MethodSpec(base, topology=lambda n, L, _f=factory: _f(n))
    if spec is None:
        known = ", ".join(sorted(set(METHOD_REGISTRY) | set(TOPOLOGY_REGISTRY)))
        raise ValueError(
            f"unknown method {method!r} (base {base!r}); known methods: "
            f"{known} — each optionally suffixed with '-sync' and/or "
            f"'-noconf' in any order")
    if aggregation or pacing:
        spec = spec.variant(aggregation=aggregation, pacing=pacing)
    return spec


def _register_builtin_methods() -> None:
    register_method(MethodSpec(
        "fedlay",
        topology=lambda n, L: TOPOLOGY_REGISTRY["fedlay"](n, L)))
    register_method(MethodSpec("fedavg", engine="fedavg",
                               aggregation="simple", pacing="sync"))
    register_method(MethodSpec("gaia", engine="gaia",
                               aggregation="simple", pacing="sync"))
    register_method(MethodSpec("dfl-dds", engine="dfl-dds",
                               aggregation="simple", pacing="sync"))
    for topo_name, factory in TOPOLOGY_REGISTRY.items():
        if topo_name == "fedlay":
            continue
        register_method(MethodSpec(
            topo_name, topology=lambda n, L, _f=factory: _f(n)))


# --------------------------------------------------------------------------
# Shared run bookkeeping
# --------------------------------------------------------------------------

class _Recorder:
    """Trace + per-client communication/compute counters, shared by every
    engine loop, and the run's count of aggregations.

    Reports into the :mod:`repro_torch.obs` plane: every snapshot ticks
    ``engine.*`` signals on the telemetry bus (the evaluations inside an
    ``engine.evaluate`` span) and — when a round ledger is installed —
    lands one ``loop="engine"`` record per evaluation point (wire bytes =
    mean per-client bytes sent since the previous snapshot);
    :meth:`result` flushes the run totals as ``engine.*`` counters.  All
    no-ops under the disabled-by-default globals."""

    def __init__(self, task: Task):
        self.task = task
        self.n = task.num_clients
        self.trace: List[TraceRow] = []
        self.bytes_sent = np.zeros(self.n)
        self.msgs_sent = np.zeros(self.n)
        self.local_steps = np.zeros(self.n)
        self.suppressed = 0
        self.aggregations = 0
        self._last_bytes = 0.0
        self._last_steps = 0.0

    def snapshot(self, t: float, params: Sequence[torch.Tensor]) -> None:
        bus = get_telemetry()
        cache: Dict[int, float] = {}      # distinct tensors evaluated once
        with bus.span("engine.evaluate"):
            for p in params:
                if id(p) not in cache:
                    cache[id(p)] = self.task.evaluate(p)
        accs = np.array([cache[id(p)] for p in params])
        self.trace.append(TraceRow(
            time=t, mean_acc=float(accs.mean()), min_acc=float(accs.min()),
            max_acc=float(accs.max()), accs=accs))
        if bus.enabled:
            bus.count("engine.evals")
            bus.gauge("engine.mean_acc", float(accs.mean()))
        ledger = get_round_ledger()
        if ledger is not None:
            mean_b = float(self.bytes_sent.mean())
            mean_s = float(self.local_steps.mean())
            ledger.record(
                round=len(self.trace) - 1, time=t, loop="engine",
                num_alive=self.n, participating=self.n,
                wire_bytes_per_client=mean_b - self._last_bytes,
                payload_bytes_per_client=mean_b - self._last_bytes,
                mean_acc=float(accs.mean()), min_acc=float(accs.min()),
                max_acc=float(accs.max()),
                local_steps_per_client=mean_s - self._last_steps)
            self._last_bytes, self._last_steps = mean_b, mean_s

    def mix(self, models: torch.Tensor, weights, *, out: torch.Tensor,
            mask=None) -> None:
        """One aggregation: ``out`` ← Σ_k w_k·models[k], in an
        ``engine.aggregate`` span.  The weights and any mask stay on the
        host as f32 tensors: ``weighted_mix`` renormalizes there and
        carries the weights in its launch, so nothing waits for the
        device."""
        with get_telemetry().span("engine.aggregate"):
            w = torch.as_tensor(weights, dtype=torch.float32)
            if mask is not None:
                mask = torch.as_tensor(mask, dtype=torch.float32)
            weighted_mix(models, w, mask=mask, out=out)
        self.aggregations += 1

    def train(self, params: torch.Tensor, client: int, seed: int) -> torch.Tensor:
        """``task.local_train`` in an ``engine.local_train`` span."""
        with get_telemetry().span("engine.local_train"):
            return self.task.local_train(params, client, seed=seed)

    def result(self, method: str, params: Sequence[torch.Tensor]) -> RunResult:
        bus = get_telemetry()
        if bus.enabled:
            bus.count("engine.bytes_sent", float(self.bytes_sent.sum()))
            bus.count("engine.msgs_sent", float(self.msgs_sent.sum()))
            bus.count("engine.local_steps", float(self.local_steps.sum()))
            bus.count("engine.suppressed", int(self.suppressed))
            bus.count("engine.aggregations", int(self.aggregations))
        return RunResult(
            method=method, trace=self.trace,
            comm_bytes_per_client=float(self.bytes_sent.mean()),
            messages_per_client=float(self.msgs_sent.mean()),
            suppressed_sends=int(self.suppressed),
            local_steps_per_client=float(self.local_steps.mean()),
            final_params=list(params), aggregations=self.aggregations)


def _rows(p0: torch.Tensor, count: int) -> torch.Tensor:
    """A (count, N) buffer on ``p0``'s device with every row ``p0``."""
    return p0.new_empty((count, p0.numel())).copy_(p0)


# --------------------------------------------------------------------------
# Round-paced engines (centralized / clustered / mobility baselines)
# --------------------------------------------------------------------------

class _FedAvgRounds:
    """Centralized FedAvg: the server averages all client models each
    round (dataset-size weighted), one aggregation a round over the
    (n, N) buffer of local models."""

    def __init__(self, task: Task, rec: _Recorder, rng: np.random.Generator,
                 seed: int, model_bytes: int, round_time: float,
                 options: Mapping[str, Any]):
        self.task, self.rec, self.rng = task, rec, rng
        self.model_bytes = model_bytes
        n = task.num_clients
        sw = np.array(options.get("sample_weights") if options.get(
            "sample_weights") is not None else
            [task.label_histogram(i).sum() for i in range(n)], np.float64)
        self.sw = sw / sw.sum()
        self.global_params = task.init_params(seed)
        self.locals = self.global_params.new_empty((n, self.global_params.numel()))

    def round(self) -> None:
        task, rng, n = self.task, self.rng, self.task.num_clients
        for u in range(n):
            self.locals[u].copy_(self.rec.train(self.global_params, u,
                                                seed=int(rng.integers(2**31))))
        self.rec.mix(self.locals, self.sw, out=self.global_params)
        self.rec.bytes_sent += 2 * self.model_bytes   # up + down per client
        self.rec.msgs_sent += 2
        self.rec.local_steps += 1

    def client_params(self) -> List[torch.Tensor]:
        return [self.global_params] * self.task.num_clients


class _GaiaRounds:
    """Gaia: FedAvg inside each geo region; region servers form a
    complete graph and simple-average each round.  No non-iid handling.

    Client u is in region ``u % R``, so a region's local models are the
    rows ``r::R`` of the (n, N) buffer: one aggregation a region over that
    view, then one across the (R, N) region buffer."""

    def __init__(self, task: Task, rec: _Recorder, rng: np.random.Generator,
                 seed: int, model_bytes: int, round_time: float,
                 options: Mapping[str, Any]):
        self.task, self.rec, self.rng = task, rec, rng
        self.model_bytes = model_bytes
        self.num_regions = int(options.get("num_regions", 4))
        n = task.num_clients
        self.region = np.arange(n) % self.num_regions
        p0 = task.init_params(seed)
        self.regions = _rows(p0, self.num_regions)
        self.region_params = list(self.regions.unbind(0))
        self.locals = p0.new_empty((n, p0.numel()))

    def round(self) -> None:
        task, rng, mb = self.task, self.rng, self.model_bytes
        n, R = task.num_clients, self.num_regions
        for r in range(R):
            members = np.nonzero(self.region == r)[0]
            for u in members:
                self.locals[u].copy_(self.rec.train(self.region_params[r], int(u),
                                                    seed=int(rng.integers(2**31))))
            self.rec.mix(self.locals[r::R], np.full(len(members), 1.0 / len(members)),
                         out=self.region_params[r])
            self.rec.bytes_sent[members] += 2 * mb
            self.rec.msgs_sent[members] += 2
        self.rec.local_steps += 1
        # inter-region complete-graph simple average (server-to-server)
        self.rec.mix(self.regions, np.full(R, 1.0 / R), out=self.region_params[0])
        self.regions[1:].copy_(self.regions[0])
        self.rec.bytes_sent += mb * R * (R - 1) / n

    def client_params(self) -> List[torch.Tensor]:
        return [self.region_params[self.region[u]]
                for u in range(self.task.num_clients)]


class _DflDdsRounds:
    """DFL-DDS-style mobility DFL: nodes move (random waypoint) in the
    unit square; each round a node simple-averages with nodes within
    ``radius``: one aggregation a client over the (n, N) client buffer,
    the neighbourhood as the mask."""

    def __init__(self, task: Task, rec: _Recorder, rng: np.random.Generator,
                 seed: int, model_bytes: int, round_time: float,
                 options: Mapping[str, Any]):
        self.task, self.rec, self.rng = task, rec, rng
        self.model_bytes = model_bytes
        self.radius = float(options.get("radius", 0.25))
        self.round_time = round_time
        n = task.num_clients
        self.pos = rng.random((n, 2))
        self.vel = (rng.random((n, 2)) - 0.5) * 0.2
        p0 = task.init_params(seed)
        self.params = _rows(p0, n)
        self._next = torch.empty_like(self.params)
        self._agg = torch.empty_like(p0)
        self._ones = np.ones(n)

    def round(self) -> None:
        task, rng, n = self.task, self.rng, self.task.num_clients
        self.pos = (self.pos + self.vel * self.round_time) % 1.0
        for u in range(n):
            d = np.linalg.norm(self.pos - self.pos[u], axis=1)
            group = d < self.radius
            group[u] = True                      # {u} ∪ its neighbours
            nbr = int(group.sum()) - 1
            self.rec.mix(self.params, self._ones, mask=group, out=self._agg)
            self._next[u].copy_(self.rec.train(self._agg, u,
                                               seed=int(rng.integers(2**31))))
            self.rec.bytes_sent[u] += self.model_bytes * nbr
            self.rec.msgs_sent[u] += nbr
        self.params, self._next = self._next, self.params
        self.rec.local_steps += 1

    def client_params(self) -> List[torch.Tensor]:
        return list(self.params.unbind(0))


_ROUND_ENGINES = {
    "fedavg": _FedAvgRounds,
    "gaia": _GaiaRounds,
    "dfl-dds": _DflDdsRounds,
}


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------

class Engine:
    """The single DFL execution front door.

    ``Engine().run(task, "fedlay", total_time=..., model_bytes=...)``
    runs any registered method (or an ad-hoc :class:`MethodSpec`) and
    returns a :class:`RunResult`; the method string accepts the
    ``-sync`` / ``-noconf`` ablation suffixes in any order.
    """

    def __init__(self, *, alpha_d: float = 0.5, alpha_c: float = 0.5):
        self.alpha_d = alpha_d
        self.alpha_c = alpha_c

    def run(self, task: Task, method: Union[str, MethodSpec], *,
            total_time: float, model_bytes: int, base_period: float = 1.0,
            num_spaces: int = 3, periods: Optional[Sequence[float]] = None,
            seed: int = 0, eval_every: float = 0.0,
            init_params: Optional[Sequence[Any]] = None,
            telemetry=None, ledger=None) -> RunResult:
        """Run one DFL method end to end.

        ``periods`` overrides the paper's 3-tier heterogeneity model
        (:func:`capacity_periods`); ``init_params`` warm-starts the
        per-client models (n flat vectors, tensors or arrays; gossip
        engine only).  ``eval_every`` paces gossip trace snapshots —
        round-paced engines always snapshot once per round.

        ``telemetry`` (a :class:`repro_torch.obs.events.Telemetry`) and
        ``ledger`` (a :class:`repro_torch.obs.rounds.RoundLedger`) scope
        the obs plane to this run: the bus/ledger are installed for the
        duration and restored afterwards.  With a bus, the gossip loop's
        parts land in the ``engine.local_train``, ``engine.fingerprint``,
        ``engine.aggregate`` and ``engine.evaluate`` span histograms
        (host time).
        """
        if telemetry is not None or ledger is not None:
            with ExitStack() as stack:
                if telemetry is not None:
                    stack.enter_context(telemetry_scope(telemetry))
                if ledger is not None:
                    stack.enter_context(ledger_scope(ledger))
                return self.run(
                    task, method, total_time=total_time,
                    model_bytes=model_bytes, base_period=base_period,
                    num_spaces=num_spaces, periods=periods, seed=seed,
                    eval_every=eval_every, init_params=init_params)
        spec = resolve_method(method) if isinstance(method, str) else method
        n = task.num_clients
        if periods is None:
            periods = capacity_periods(n, base_period, seed=seed)
        periods = np.asarray(periods, dtype=np.float64)

        if spec.engine == "gossip":
            topo = spec.topology
            if topo is None:
                raise ValueError(
                    f"gossip method {spec.name!r} needs a topology")
            if not isinstance(topo, Topology):
                topo = topo(n, num_spaces)
            return self._run_gossip(task, spec, topo, periods,
                                    total_time=total_time,
                                    model_bytes=model_bytes, seed=seed,
                                    eval_every=eval_every,
                                    init_params=init_params)

        impl_cls = _ROUND_ENGINES.get(spec.engine)
        if impl_cls is None:
            raise ValueError(
                f"unknown engine {spec.engine!r} for method {spec.name!r}; "
                f"expected 'gossip' or one of {sorted(_ROUND_ENGINES)}")
        if init_params is not None:
            raise ValueError(
                f"init_params warm-start is only supported by the gossip "
                f"engine, not {spec.engine!r}")
        return self._run_rounds(task, spec, impl_cls, periods,
                                total_time=total_time,
                                model_bytes=model_bytes, seed=seed)

    # -- round-paced loop (fedavg / gaia / dfl-dds) ------------------------

    def _run_rounds(self, task: Task, spec: MethodSpec, impl_cls, periods,
                    *, total_time: float, model_bytes: int,
                    seed: int) -> RunResult:
        """Synchronous rounds paced by the slowest client — the one loop
        behind every centralized/clustered baseline."""
        rec = _Recorder(task)
        rng = np.random.default_rng(seed)
        round_time = float(np.max(periods))
        impl = impl_cls(task, rec, rng, seed, model_bytes, round_time,
                        dict(spec.options))
        rec.snapshot(0.0, impl.client_params())
        t = 0.0
        while t + round_time <= total_time:
            t += round_time
            impl.round()
            rec.snapshot(t, impl.client_params())
        return rec.result(spec.name, impl.client_params())

    # -- asynchronous gossip loop (FedLay and topology baselines) ----------

    def _run_gossip(self, task: Task, spec: MethodSpec, topology: Topology,
                    periods, *, total_time: float, model_bytes: int,
                    seed: int, eval_every: float,
                    init_params: Optional[Sequence[Any]]) -> RunResult:
        """Event-driven asynchronous DFL gossip (MEP semantics).

        Every client u wakes at its own period T_u (sync pacing: all
        clients paced by max T): aggregate the latest models received
        from neighbors with confidence weights, run local training, then
        send the new model to each neighbor unless (a) the per-link
        period max(T_u,T_v) has not elapsed or (b) the fingerprint is
        unchanged.
        """
        n = task.num_clients
        confidence_weighted = spec.aggregation != "simple"
        rng = np.random.default_rng(seed)
        nbrs = topology.neighbor_map()
        profiles = make_profiles(task, periods)
        if spec.pacing == "sync":
            periods = np.full(n, float(np.max(periods)))

        p0 = task.init_params(seed)
        D = max((len(v) for v in nbrs.values()), default=0)
        # buf[u, 0]: client u's model; buf[u, 1 + j]: the latest model
        # received from nbrs[u][j] (zeros, weight 0, until one arrives)
        buf = p0.new_zeros((n, 1 + D, p0.numel()))
        if init_params is not None:
            if len(init_params) != n:
                raise ValueError(f"init_params holds {len(init_params)} vectors "
                                 f"for {n} clients")
            for u, p in enumerate(init_params):
                buf[u, 0].copy_(torch.as_tensor(p))
        else:
            buf[:, 0].copy_(p0)
        params = list(buf[:, 0].unbind(0))
        slot = {u: {v: j for j, v in enumerate(vs)} for u, vs in nbrs.items()}
        received = np.zeros((n, D), dtype=bool)
        senders: List[List[int]] = [[] for _ in range(n)]   # first-receipt order
        fingerprints = [FingerprintTable() for _ in range(n)]
        last_link_send: Dict[Tuple[int, int], float] = {}
        rec = _Recorder(task)
        bus = get_telemetry()

        heap: List[Tuple[float, int, int]] = []
        counter = itertools.count()
        for u in range(n):
            heapq.heappush(heap, (float(periods[u]) * (0.5 + 0.5 * rng.random()),
                                  next(counter), u))

        eval_every = eval_every or max(float(np.max(periods)), total_time / 20.0)
        rec.snapshot(0.0, params)
        next_eval = eval_every
        now = 0.0
        while heap and heap[0][0] <= total_time:
            now, _, u = heapq.heappop(heap)
            while next_eval <= now:
                rec.snapshot(next_eval, params)
                next_eval += eval_every
            # 1) MEP aggregation over {u} ∪ received neighbor models
            if senders[u]:
                w = aggregation_weights(profiles[u],
                                        [profiles[v] for v in senders[u]],
                                        self.alpha_d, self.alpha_c,
                                        confidence_weighted)
                slot_w = np.zeros(1 + D)
                slot_w[0] = w[0]
                for k, v in enumerate(senders[u]):
                    slot_w[1 + slot[u][v]] = w[k + 1]
                rec.mix(buf[u], slot_w, out=params[u])
            # 2) local training
            params[u].copy_(rec.train(params[u], u, seed=int(rng.integers(2**31))))
            rec.local_steps[u] += 1
            # 3) push to neighbors (link period + fingerprint suppression)
            with bus.span("engine.fingerprint"):
                fp = model_fingerprint(params[u])
            for v in nbrs[u]:
                lp = link_period(float(periods[u]), float(periods[v]))
                last = last_link_send.get((u, v), -np.inf)
                if now - last < lp * 0.999:
                    continue
                if not fingerprints[u].should_send(v, fp):
                    continue
                fingerprints[u].record(v, fp)
                j = slot[v][u]
                buf[v, 1 + j].copy_(params[u])
                if not received[v, j]:
                    received[v, j] = True
                    senders[v].append(u)
                last_link_send[(u, v)] = now
                rec.bytes_sent[u] += model_bytes
                rec.msgs_sent[u] += 1
            heapq.heappush(heap, (now + float(periods[u]), next(counter), u))
        while next_eval <= total_time:
            rec.snapshot(next_eval, params)
            next_eval += eval_every

        rec.suppressed = sum(f.suppressed for f in fingerprints)
        return rec.result(spec.name, params)


_register_builtin_methods()


# --------------------------------------------------------------------------
# Compatibility wrapper
# --------------------------------------------------------------------------

def run_gossip(task: Task, topology: Topology, periods: Sequence[float],
               total_time: float, model_bytes: int,
               confidence_weighted: bool = True,
               synchronous: bool = False,
               alpha_d: float = 0.5, alpha_c: float = 0.5,
               eval_every: float = 0.0, seed: int = 0,
               method_name: str = "gossip",
               init_params: Optional[Sequence[Any]] = None) -> RunResult:
    """Gossip over an explicit topology — sugar for :meth:`Engine.run`
    with an ad-hoc :class:`MethodSpec` (custom overlays, churn phases)."""
    spec = MethodSpec(
        name=method_name, engine="gossip", topology=topology,
        aggregation="confidence" if confidence_weighted else "simple",
        pacing="sync" if synchronous else "async")
    return Engine(alpha_d=alpha_d, alpha_c=alpha_c).run(
        task, spec, total_time=total_time, model_bytes=model_bytes,
        periods=periods, seed=seed, eval_every=eval_every,
        init_params=init_params)
