"""Device capability probe and the plain path's tuning.

Counterpart of ``faiss_tpu/resources.py``. PyTorch runs eagerly, so there is
no compiled-function cache and no mesh here; what is left is a description
of the card (for ``describe()`` and for every reported number) and the one
tunable the plain path reads, ``chunk_v``.
"""

from __future__ import annotations

import dataclasses
import shutil
import subprocess
from typing import Optional

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
