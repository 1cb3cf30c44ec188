"""Devices, capability probe, the plain path's tuning and the program cache.

Counterpart of ``faiss_tpu/resources.py``: a description of the card (for
``describe()`` and for every reported number), the one tunable the plain
path reads (``chunk_v``), and ``TorchResources``, which owns the devices
and the cache of search programs. On a CUDA device a search program is
the search captured once per shape as a CUDA graph and replayed
(``programs.py``), the counterpart of ``faiss_tpu``'s one compiled program
per shape; on the CPU it is the eager function, which runs the kernels'
plain versions (the counterpart of ``interpret=True``).
"""

from __future__ import annotations

import dataclasses
import shutil
import subprocess
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class KernelTuning:
    # nv chunk of the plain path's two-stage top-k: one (nq, chunk_v) f32
    # score block is live at a time
    chunk_v: int = 256 * 1024
    # provenance of the values: "measured" on this kind of device, or not
    source: str = "default"


# The JAX package's per-generation entries are TPU values and do not carry
# over. The GPU entry is the JAX default chunk, kept as a default.
_KIND_TUNING = {
    "cuda": KernelTuning(source="default, not measured"),
    "cpu": KernelTuning(chunk_v=64 * 1024, source="default, not measured"),
}


@dataclasses.dataclass(frozen=True)
class DeviceCapabilities:
    """Runtime description of the device an index lives on."""

    device_type: str                 # "cuda" | "cpu"
    name: str
    sm_count: Optional[int]
    memory_bytes: Optional[int]
    compute_capability: Optional[tuple]
    tuning: KernelTuning

    def describe(self) -> str:
        return "\n".join([
            "faiss_tpu_torch device capabilities:",
            f"  device              : {self.device_type} ({self.name})",
            f"  SMs                 : {self.sm_count}",
            f"  memory_bytes        : {self.memory_bytes}",
            f"  compute capability  : {self.compute_capability}",
            f"  tuning ({self.tuning.source}) : chunk_v={self.tuning.chunk_v}",
        ])


def query_device_capabilities(device) -> DeviceCapabilities:
    device = torch.device(device)
    if device.type == "cuda":
        p = torch.cuda.get_device_properties(device)
        return DeviceCapabilities(
            device_type="cuda", name=p.name,
            sm_count=p.multi_processor_count,
            memory_bytes=p.total_memory,
            compute_capability=(p.major, p.minor),
            tuning=_KIND_TUNING["cuda"])
    if device.type == "cpu":
        return DeviceCapabilities(
            device_type="cpu", name="cpu", sm_count=None, memory_bytes=None,
            compute_capability=None, tuning=_KIND_TUNING["cpu"])
    raise ValueError(f"unsupported device {device}")


def describe_capabilities(caps=None, device="cuda") -> str:
    """``caps.describe()``, or that of ``device``'s capabilities; ``caps``
    may also name the device (``describe_capabilities("cpu")``)."""
    if caps is None or isinstance(caps, (str, torch.device)):
        caps = query_device_capabilities(device if caps is None else caps)
    return caps.describe()


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    the line every reported number stands beside (a card may be capped
    below its maximum power and then runs slower under load)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def _resolve_devices(devices) -> List[torch.device]:
    """``devices`` as torch devices with their index ("cuda" names the
    current card); None: every visible CUDA device, and a RuntimeError
    where there is none."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=['cpu'] "
                               "to run the plain versions of the kernels")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = [canonical_device(d) for d in devices]
    if not out:
        raise ValueError("devices is empty")
    return out


def canonical_device(device) -> torch.device:
    """``device`` with its index: "cuda" is the current card, "cuda:1"
    stays itself; every CPU device is "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.device(device.type)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain versions of the kernels")
    if device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class TorchResources:
    """Devices and the cache of search programs; one object that indexes
    share (``faiss_tpu``'s TpuResources).

    ``devices`` defaults to every visible CUDA device and raises without
    one; ``["cpu"]`` runs the plain versions (the tests). ``cached(key,
    builder)`` builds each key's program once: the builder runs outside
    the one lock under a per-key event, so a slow build (a capture) never
    blocks another key's lookup, concurrent callers of one key wait for
    its build, and when the owner's builder raises, the waiters build
    again. ``discard(pred)`` drops the entries whose key ``pred`` accepts
    (an index's entries when it changes or is collected); a dropped CUDA
    graph frees its private memory pool (a replay in flight completes
    first).

    ``faiss_tpu``'s ``mesh`` has no counterpart: the port's sharding is one
    process over a list of devices (``ShardedIndexFlat``), not a mesh."""

    def __init__(self, devices: Optional[Sequence] = None):
        self._devices = _resolve_devices(devices)
        self._caps = query_device_capabilities(self._devices[0])
        self._cache: Dict[Any, Any] = {}
        self._pending: Dict[Any, threading.Event] = {}
        self._hits = self._misses = 0
        # re-entrant: a collected index's finalizer discards its entries,
        # and the collection may run inside a locked region of this thread
        self._lock = threading.RLock()

    @property
    def devices(self) -> List[torch.device]:
        return list(self._devices)

    @property
    def capabilities(self) -> DeviceCapabilities:
        return self._caps

    @property
    def default_device(self) -> torch.device:
        return self._devices[0]

    def cached(self, key, builder: Callable[[], Any]):
        """Return cache[key], building it once if absent (``faiss_tpu``'s
        semantics, line for line)."""
        with self._lock:
            got = self._cache.get(key)
            if got is not None:
                self._hits += 1
            else:
                pending = self._pending.get(key)
                if pending is None:
                    pending = self._pending[key] = threading.Event()
                    owner = True
                    self._misses += 1
                else:
                    owner = False
        if got is not None:
            return got
        if not owner:
            pending.wait()
            with self._lock:
                if key in self._cache:
                    self._hits += 1
                    return self._cache[key]
            # the owner's builder raised: build in this thread
            return self.cached(key, builder)
        try:
            fn = builder()
        except BaseException:
            with self._lock:
                self._pending.pop(key, None)
            pending.set()
            raise
        with self._lock:
            self._cache[key] = fn
            self._pending.pop(key, None)
        pending.set()
        return fn

    def discard(self, pred: Callable[[Any], bool]) -> int:
        """Drop every entry whose key ``pred`` accepts; returns how many."""
        with self._lock:
            gone = [self._cache.pop(k) for k in list(self._cache) if pred(k)]
        return len(gone)

    def cache_info(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._cache)}

    def program_stats(self) -> Dict[str, int]:
        """Lookups of ``cached`` since the resources were made: ``hits``
        found the key's program (built, or built meanwhile by another
        caller), ``misses`` built it. A deployment whose shapes have
        settled adds hits only."""
        with self._lock:
            return {"hits": self._hits, "misses": self._misses}

    def describe(self) -> str:
        return (self._caps.describe()
                + f"\n  fn-cache entries    : {self.cache_info()['entries']}")


def bind_device(device, resources: Optional[TorchResources]):
    """(device, resources) of an index, a Kmeans or a loader: ``device``
    None takes the resources' default device ("cuda" without resources),
    ``resources`` None the process-wide one of the device's type
    (``default_resources``); a device outside the resources' devices
    raises ValueError."""
    if device is None:
        device = "cuda" if resources is None else resources.default_device
    device = torch.device(device)
    res = resources if resources is not None else default_resources(device)
    if canonical_device(device) not in res.devices:
        raise ValueError(f"device {device} is not one of the resources' "
                         f"devices {res.devices}")
    return device, res


_default_resources: Dict[str, TorchResources] = {}
_default_lock = threading.Lock()


def default_resources(device="cuda") -> TorchResources:
    """The process-wide TorchResources of ``device``'s type: every visible
    CUDA device (raises without one), or ``["cpu"]`` for "cpu". Indexes
    built without ``resources=`` share it."""
    kind = torch.device(device).type
    with _default_lock:
        res = _default_resources.get(kind)
        if res is None:
            res = _default_resources[kind] = TorchResources(
                None if kind == "cuda" else [kind])
        return res
