"""Device fingerprinting for shippable machine profiles — the counterpart
of ``repro.profiles.fingerprint``, read from PyTorch instead of
``jax.devices()``: on the card ``platform="gpu"`` with
``torch.cuda.get_device_name()`` and ``torch.cuda.device_count()``; on
the host ``"cpu"``/``"cpu"``/1.  The JSON form is the reference's."""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class DeviceFingerprint:
    """Identity of the measured machine."""

    platform: str       # "cpu" / "gpu"
    device_kind: str    # e.g. "cpu", "NVIDIA H100 80GB HBM3"
    n_devices: int

    @classmethod
    def local(cls, device: DeviceLike = "cuda") -> "DeviceFingerprint":
        dev = resolve_device(device)
        if dev.type == "cuda":
            return cls(platform="gpu",
                       device_kind=torch.cuda.get_device_name(dev),
                       n_devices=torch.cuda.device_count())
        return cls(platform=dev.type, device_kind=dev.type, n_devices=1)

    @property
    def id(self) -> str:
        """Stable slug usable in filenames and cache keys."""
        kind = re.sub(r"[^A-Za-z0-9]+", "-", self.device_kind).strip("-")
        return f"{self.platform}_{kind}_x{self.n_devices}"

    def to_dict(self) -> Dict[str, Any]:
        return {"platform": self.platform, "device_kind": self.device_kind,
                "n_devices": self.n_devices}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeviceFingerprint":
        return cls(platform=str(d["platform"]),
                   device_kind=str(d["device_kind"]),
                   n_devices=int(d["n_devices"]))
