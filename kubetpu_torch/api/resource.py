"""Resource quantity parsing and arithmetic.

Re-design of Kubernetes resource quantities for dense tensors
(reference: staging/src/k8s.io/apimachinery/pkg/api/resource/quantity.go).

Instead of the reference's arbitrary-precision ``inf.Dec`` quantities we
normalize every resource to an integer *milli-unit* (int), which is exact for
every value the scheduler ever compares (CPU in millicores, memory in bytes,
etc.).  Device-side, each resource channel is scaled to fit exactly in f32
(see kubetpu_torch/state/tensors.py) so the fit comparison ``allocatable >=
requested + used`` is bit-exact on the device.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, Union

# Binary (Ki/Mi/Gi...) and decimal (k/M/G...) suffix multipliers.
_BIN = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DEC = {"n": 10**-9, "u": 10**-6, "m": 10**-3, "": 1,
        "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18}

_QTY_RE = re.compile(r"^([+-]?[0-9.]+)([numkMGTPEi]{0,2})$")


def parse_quantity(s: Union[str, int, float]) -> float:
    """Parse a Kubernetes quantity string ("100m", "32Gi", "4") to a float
    in base units (cores, bytes, counts).  String parses are memoized: a
    cluster's quantity vocabulary is tiny, and hot host paths (the PVC
    matchable-PV scan probes every (PV, requirement-signature) pair per
    overlay build) re-parse the same strings every cycle."""
    if isinstance(s, (int, float)):
        return float(s)
    return _parse_quantity_str(s)


@functools.lru_cache(maxsize=4096)
def _parse_quantity_str(s: str) -> float:
    s = s.strip()
    m = _QTY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {s!r}")
    num, suffix = m.groups()
    value = float(num)
    if suffix in _BIN:
        return value * _BIN[suffix]
    if suffix in _DEC:
        return value * _DEC[suffix]
    raise ValueError(f"invalid quantity suffix: {s!r}")


def to_milli(s: Union[str, int, float]) -> int:
    """Quantity -> integer milli-units (reference: Quantity.MilliValue)."""
    return int(round(parse_quantity(s) * 1000))


def to_int(s: Union[str, int, float]) -> int:
    """Quantity -> integer base units, rounding up (reference: Quantity.Value)."""
    import math
    return int(math.ceil(parse_quantity(s)))


# Well-known resource names (reference: staging/src/k8s.io/api/core/v1/types.go:5267).
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"

DEFAULT_MILLI_CPU_REQUEST = 100            # 0.1 core
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024  # 200 MB
# reference: pkg/scheduler/util/non_zero.go:30-48 (GetNonzeroRequestForResource)


def is_extended(name: str) -> bool:
    """Extended (scalar) resources: anything not in the native set and not a
    hugepages-style prefix handled natively.
    reference: pkg/apis/core/v1/helper/helpers.go (IsScalarResourceName)."""
    return name not in (CPU, MEMORY, EPHEMERAL_STORAGE, PODS)


class Resource:
    """Aggregated resource vector in integer units.

    cpu is millicores; memory/ephemeral-storage are bytes; scalar resources
    are in their native integer unit.
    reference: pkg/scheduler/framework/v1alpha1/types.go:262 (Resource).
    """

    __slots__ = ("milli_cpu", "memory", "ephemeral_storage", "allowed_pod_number",
                 "scalar_resources")

    def __init__(self, milli_cpu: int = 0, memory: int = 0, ephemeral_storage: int = 0,
                 allowed_pod_number: int = 0, scalar_resources: Dict[str, int] | None = None):
        self.milli_cpu = milli_cpu
        self.memory = memory
        self.ephemeral_storage = ephemeral_storage
        self.allowed_pod_number = allowed_pod_number
        self.scalar_resources: Dict[str, int] = dict(scalar_resources or {})

    @classmethod
    def from_resource_list(cls, rl: Dict[str, Union[str, int, float]]) -> "Resource":
        r = cls()
        r.add_resource_list(rl)
        return r

    def add_resource_list(self, rl: Dict[str, Union[str, int, float]]) -> None:
        # reference: types.go:286 (Resource.Add)
        for name, q in (rl or {}).items():
            if name == CPU:
                self.milli_cpu += to_milli(q)
            elif name == MEMORY:
                self.memory += to_int(q)
            elif name == EPHEMERAL_STORAGE:
                self.ephemeral_storage += to_int(q)
            elif name == PODS:
                self.allowed_pod_number += to_int(q)
            else:
                self.scalar_resources[name] = self.scalar_resources.get(name, 0) + to_int(q)

    def set_max(self, rl: Dict[str, Union[str, int, float]]) -> None:
        # reference: types.go:331 (Resource.SetMaxResource)
        for name, q in (rl or {}).items():
            if name == CPU:
                self.milli_cpu = max(self.milli_cpu, to_milli(q))
            elif name == MEMORY:
                self.memory = max(self.memory, to_int(q))
            elif name == EPHEMERAL_STORAGE:
                self.ephemeral_storage = max(self.ephemeral_storage, to_int(q))
            elif name == PODS:
                self.allowed_pod_number = max(self.allowed_pod_number, to_int(q))
            else:
                self.scalar_resources[name] = max(self.scalar_resources.get(name, 0), to_int(q))

    def add(self, other: "Resource") -> None:
        self.milli_cpu += other.milli_cpu
        self.memory += other.memory
        self.ephemeral_storage += other.ephemeral_storage
        self.allowed_pod_number += other.allowed_pod_number
        for k, v in other.scalar_resources.items():
            self.scalar_resources[k] = self.scalar_resources.get(k, 0) + v

    def sub(self, other: "Resource") -> None:
        self.milli_cpu -= other.milli_cpu
        self.memory -= other.memory
        self.ephemeral_storage -= other.ephemeral_storage
        self.allowed_pod_number -= other.allowed_pod_number
        for k, v in other.scalar_resources.items():
            self.scalar_resources[k] = self.scalar_resources.get(k, 0) - v

    def clone(self) -> "Resource":
        return Resource(self.milli_cpu, self.memory, self.ephemeral_storage,
                        self.allowed_pod_number, dict(self.scalar_resources))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Resource):
            return NotImplemented
        return (self.milli_cpu == other.milli_cpu and self.memory == other.memory
                and self.ephemeral_storage == other.ephemeral_storage
                and self.allowed_pod_number == other.allowed_pod_number
                and self.scalar_resources == other.scalar_resources)

    def __repr__(self) -> str:
        return (f"Resource(cpu={self.milli_cpu}m, mem={self.memory}, "
                f"eph={self.ephemeral_storage}, pods={self.allowed_pod_number}, "
                f"scalar={self.scalar_resources})")
