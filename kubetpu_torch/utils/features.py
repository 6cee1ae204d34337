"""Feature gates.

reference: staging/src/k8s.io/component-base/featuregate/feature_gate.go:33
(featureGate) and pkg/features/kube_features.go (83 gates; the
scheduler-relevant subset is mirrored here with the same stages).
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple

ALPHA, BETA, GA, DEPRECATED = "ALPHA", "BETA", "GA", "DEPRECATED"


class FeatureSpec(NamedTuple):
    default: bool
    pre_release: str
    lock_to_default: bool = False


# scheduler-relevant gates (reference: pkg/features/kube_features.go)
DEFAULT_FEATURES: Dict[str, FeatureSpec] = {
    "EvenPodsSpread": FeatureSpec(True, GA),            # :366
    "BalanceAttachedNodeVolumes": FeatureSpec(False, ALPHA),  # :155
    "PodOverhead": FeatureSpec(True, BETA),             # :432
    "CSIMigration": FeatureSpec(True, BETA),
    "VolumeScheduling": FeatureSpec(True, GA, lock_to_default=True),
    "PodDisruptionBudget": FeatureSpec(True, BETA),
    "ServiceAffinity": FeatureSpec(False, ALPHA),
    "NonPreemptingPriority": FeatureSpec(False, ALPHA),  # :392
    "DefaultPodTopologySpread": FeatureSpec(False, ALPHA),
    "AllAlpha": FeatureSpec(False, ALPHA),
    "AllBeta": FeatureSpec(False, BETA),
}


class FeatureGate:
    """reference: featuregate/feature_gate.go:33."""

    def __init__(self, known: Dict[str, FeatureSpec] = None):
        self._known = dict(known if known is not None else DEFAULT_FEATURES)  # kubelint: guarded-by(_lock)
        self._enabled: Dict[str, bool] = {}  # kubelint: guarded-by(_lock)
        self._lock = threading.Lock()

    def enabled(self, key: str) -> bool:
        with self._lock:
            if key in self._enabled:
                return self._enabled[key]
            spec = self._known.get(key)
            if spec is None:
                raise KeyError(f"unknown feature gate {key}")
            if spec.pre_release == ALPHA and self._enabled.get("AllAlpha"):
                return True
            if spec.pre_release == BETA and self._enabled.get("AllBeta"):
                return True
            return spec.default

    def set(self, key: str, value: bool) -> None:
        with self._lock:
            spec = self._known.get(key)
            if spec is None:
                raise KeyError(f"unknown feature gate {key}")
            if spec.lock_to_default and value != spec.default:
                raise ValueError(
                    f"cannot set feature gate {key} to {value}: locked to "
                    f"{spec.default}")
            self._enabled[key] = value

    def set_from_map(self, m: Dict[str, bool]) -> None:
        for k, v in m.items():
            self.set(k, v)

    def add(self, key: str, spec: FeatureSpec) -> None:
        with self._lock:
            self._known[key] = spec

    def known_features(self):
        with self._lock:
            return {k: v for k, v in self._known.items()}


DEFAULT_FEATURE_GATE = FeatureGate()
