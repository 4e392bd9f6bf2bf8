"""MEP — Model Exchange Protocol (paper §III-C).

Three components, exactly as the paper specifies:

1. **Asynchronous model exchange** — each client u has its own period
   ``T_u`` (coarse device-tier presets or fine-grained
   ``T_u = η·T_{u,min}``); neighbors (u,v) exchange at period
   ``max(T_u, T_v)``.
2. **Confidence parameters** —
   ``c_d^u = exp(-KL(D_loc ‖ D_iid))`` (data-divergence confidence,
   D_iid estimated as uniform over labels) and ``c_c^u = 1/T_u``
   (communication confidence); the overall confidence
   ``c^u = α_d·c_d^u/max_N(c_d) + α_c·c_c^u/max_N(c_c)`` normalizes by
   the *neighborhood* maxima.  Aggregation is the confidence-weighted
   average over ``{u} ∪ N_u``.
3. **Model fingerprinting** — a public hash of the weights; a neighbor
   holding a matching fingerprint skips the (re)send.

A copy of ``repro/core/mep.py`` (pure numpy); :func:`model_fingerprint`
also takes a tensor, which it copies to the host first.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .coords import fnv1a_64


# --------------------------------------------------------------------------
# Device tiers (coarse-grained period presets, paper §III-C1 + §IV-A2)
# --------------------------------------------------------------------------

#: Relative period multipliers for the paper's three capacity tiers:
#: high-capacity clients run at 2/3 the period of medium ones, low at 2x.
TIER_MULTIPLIER = {"high": 2.0 / 3.0, "medium": 1.0, "low": 2.0}

#: Coarse device/communication type presets (relative units).
DEVICE_PRESETS = {
    "server-lan": 0.5,
    "pc-lan": 2.0 / 3.0,
    "laptop-wlan": 1.0,
    "phone-lte": 1.5,
    "iot-wlan": 2.0,
}


def tier_period(base_period: float, tier: str) -> float:
    return base_period * TIER_MULTIPLIER[tier]


def fine_grained_period(t_min: float, eta: float = 1.2) -> float:
    """Fine-grained setting: T_u = η·T_{u,min}, η > 1."""
    if eta <= 1.0:
        raise ValueError("η must be > 1")
    return eta * t_min


def link_period(t_u: float, t_v: float) -> float:
    """Per-link exchange period = max(T_u, T_v)."""
    return max(t_u, t_v)


# --------------------------------------------------------------------------
# Confidence parameters
# --------------------------------------------------------------------------

def kl_divergence(p: np.ndarray, q: np.ndarray, eps: float = 1e-12) -> float:
    """KL(p ‖ q) with clamping; p, q are label histograms (normalized here)."""
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    p = p / max(p.sum(), eps)
    q = q / max(q.sum(), eps)
    mask = p > eps
    return float(np.sum(p[mask] * np.log(p[mask] / np.maximum(q[mask], eps))))


def data_confidence(label_histogram: np.ndarray,
                    iid_distribution: Optional[np.ndarray] = None) -> float:
    """c_d = 1 / exp(KL(D_loc ‖ D_iid)) ∈ (0, 1]; D_iid defaults to uniform."""
    hist = np.asarray(label_histogram, dtype=np.float64)
    if iid_distribution is None:
        iid_distribution = np.full(hist.shape, 1.0 / hist.size)
    return float(np.exp(-kl_divergence(hist, iid_distribution)))


def communication_confidence(period: float) -> float:
    """c_c = 1 / T_u."""
    return 1.0 / period


@dataclasses.dataclass(frozen=True)
class ClientProfile:
    """Everything MEP needs to know about one client."""

    client_id: int
    period: float                       # T_u
    label_histogram: np.ndarray         # local label counts
    iid_distribution: Optional[np.ndarray] = None

    @property
    def c_d(self) -> float:
        return data_confidence(self.label_histogram, self.iid_distribution)

    @property
    def c_c(self) -> float:
        return communication_confidence(self.period)


def overall_confidence(profile: ClientProfile,
                       neighborhood: Sequence[ClientProfile],
                       alpha_d: float = 0.5, alpha_c: float = 0.5) -> float:
    """c^u = α_d·c_d/max(c_d) + α_c·c_c/max(c_c), maxima over u's
    neighborhood (paper: "from all u's neighbors"; we include u itself so
    the normalization is well defined for isolated nodes)."""
    group = list(neighborhood) + [profile]
    max_cd = max(p.c_d for p in group)
    max_cc = max(p.c_c for p in group)
    return alpha_d * profile.c_d / max_cd + alpha_c * profile.c_c / max_cc


def aggregation_weights(self_profile: ClientProfile,
                        neighbor_profiles: Sequence[ClientProfile],
                        alpha_d: float = 0.5, alpha_c: float = 0.5,
                        confidence_weighted: bool = True) -> np.ndarray:
    """Normalized aggregation weights over [self] + neighbors.

    ``confidence_weighted=False`` gives the simple-average ablation
    (paper Figs. 16/17)."""
    all_profiles = [self_profile] + list(neighbor_profiles)
    if not confidence_weighted:
        w = np.ones(len(all_profiles))
    else:
        w = np.array([
            overall_confidence(p, [q for q in all_profiles if q is not p],
                               alpha_d, alpha_c)
            for p in all_profiles
        ])
    return w / w.sum()


# --------------------------------------------------------------------------
# Model fingerprinting
# --------------------------------------------------------------------------

def model_fingerprint(flat_params) -> int:
    """Public 64-bit fingerprint of a model (paper §III-C3).

    Hashes the raw bytes of the (float32-rounded) parameter vector so
    that the sender and receiver compute identical fingerprints.  A
    tensor (on any device) is copied to the host first, so a flat vector
    gives the reference's fingerprint whichever package holds it."""
    if hasattr(flat_params, "detach"):
        flat_params = flat_params.detach().float().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(flat_params, dtype=np.float32))
    return fnv1a_64(arr.tobytes())


class FingerprintTable:
    """Per-client table of the last fingerprint seen from each neighbor —
    sends are suppressed when the fingerprint is unchanged."""

    def __init__(self) -> None:
        self._last: Dict[int, int] = {}
        self.suppressed = 0
        self.sent = 0

    def should_send(self, neighbor: int, fingerprint: int) -> bool:
        if self._last.get(neighbor) == fingerprint:
            self.suppressed += 1
            return False
        self.sent += 1
        return True

    def record(self, neighbor: int, fingerprint: int) -> None:
        self._last[neighbor] = fingerprint

    def forget(self, neighbor: int) -> None:
        self._last.pop(neighbor, None)
