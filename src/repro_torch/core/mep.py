"""MEP — Model Exchange Protocol (paper §III-C): the confidence weights.

A copy of ``repro/core/mep.py``, trimmed to what the DFL round calls
(device-tier presets and model fingerprints stay with the reference).
The data-divergence confidence is ``c_d^u = exp(-KL(D_loc ‖ D_iid))``
(D_iid uniform over labels), the communication confidence is
``c_c^u = 1/T_u``, and the overall confidence
``c^u = α_d·c_d^u/max_N(c_d) + α_c·c_c^u/max_N(c_c)`` normalizes by the
*neighborhood* maxima.  Aggregation is the confidence-weighted average
over ``{u} ∪ N_u``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


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
        return 1.0 / self.period


def overall_confidence(profile: ClientProfile,
                       neighborhood: Sequence[ClientProfile],
                       alpha_d: float = 0.5, alpha_c: float = 0.5) -> float:
    """c^u = α_d·c_d/max(c_d) + α_c·c_c/max(c_c), maxima over u's
    neighborhood and u itself."""
    group = list(neighborhood) + [profile]
    max_cd = max(p.c_d for p in group)
    max_cc = max(p.c_c for p in group)
    return alpha_d * profile.c_d / max_cd + alpha_c * profile.c_c / max_cc


def aggregation_weights(self_profile: ClientProfile,
                        neighbor_profiles: Sequence[ClientProfile],
                        alpha_d: float = 0.5, alpha_c: float = 0.5,
                        confidence_weighted: bool = True) -> np.ndarray:
    """Normalized aggregation weights over [self] + neighbors
    (``confidence_weighted=False``: the simple-average ablation)."""
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
