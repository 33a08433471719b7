"""Platform services: hardware capability probe + model-URI resolution
(counterpart of the JAX package's ``platform.py``).

Reference counterparts:
  - hw_accel.c (cpu_neon_accel_available via getauxval): here the probe
    reports the accelerator that matters on this stack — CUDA devices via
    ``torch.cuda`` (count, name, sm capability, total memory), plus host
    SIMD hints from /proc/cpuinfo.
  - ml_agent.c (mlagent_get_model_path_from): resolves ``mlagent://``
    model URIs through a model registry; ours is a JSON file DB
    (``~/.config/nnstreamer_tpu/models.json`` or $NNSTPU_MODEL_DB)
    mapping name → {version → path}, the file-based analogue of the
    Tizen ML-Agent model database. The same file serves both packages.
"""

from __future__ import annotations

import json
import os
from typing import Dict
from urllib.parse import urlparse

__all__ = ["hw_capabilities", "resolve_model_uri", "register_model_path"]


def hw_capabilities(probe_device: bool = True) -> Dict:
    """Runtime hardware probe (hw_accel.c parity, CUDA-first). The device
    fields describe CUDA device 0; ``platform`` is ``gpu`` when torch sees
    a card and ``cpu`` otherwise."""
    caps: Dict = {
        "platform": "unknown",
        "has_gpu": False,
        "gpu_kind": None,
        "sm_capability": None,
        "total_memory_bytes": None,
        "num_devices": 0,
        "cpu_count": os.cpu_count() or 1,
        "simd": [],
    }
    try:
        with open("/proc/cpuinfo", "r", encoding="utf-8") as f:
            cpuinfo = f.read()
        for feat in ("avx2", "avx512f", "neon", "asimd", "sse4_2"):
            if feat in cpuinfo:
                caps["simd"].append(feat)
    except OSError:
        pass
    if probe_device:
        import torch

        if torch.cuda.is_available():
            props = torch.cuda.get_device_properties(0)
            caps.update(
                platform="gpu", has_gpu=True,
                num_devices=torch.cuda.device_count(),
                gpu_kind=torch.cuda.get_device_name(0),
                sm_capability=f"{props.major}.{props.minor}",
                total_memory_bytes=int(props.total_memory))
        else:
            caps["platform"] = "cpu"
    return caps


def _db_path() -> str:
    return os.environ.get(
        "NNSTPU_MODEL_DB",
        os.path.join(
            os.path.expanduser("~"), ".config", "nnstreamer_tpu", "models.json"
        ),
    )


def _load_db() -> Dict:
    path = _db_path()
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def register_model_path(
    name: str, path: str, version: str = "1", activate: bool = True
) -> None:
    """Add a model to the registry DB (the ml-agent 'register model' verb)."""
    db = _load_db()
    entry = db.setdefault(name, {"versions": {}, "active": None})
    entry["versions"][str(version)] = os.path.abspath(path)
    if activate or entry["active"] is None:
        entry["active"] = str(version)
    db_file = _db_path()
    os.makedirs(os.path.dirname(db_file), exist_ok=True)
    with open(db_file, "w", encoding="utf-8") as f:
        json.dump(db, f, indent=2)


def resolve_model_uri(uri: str) -> str:
    """Resolve ``mlagent://model/<name>[/<version>]`` to a file path
    (mlagent_get_model_path_from parity, ml_agent.c:33-70). Non-mlagent
    strings pass through unchanged."""
    if not uri.startswith("mlagent://"):
        return uri
    parsed = urlparse(uri)
    parts = [p for p in (parsed.netloc + parsed.path).split("/") if p]
    if len(parts) < 2 or parts[0] != "model":
        raise ValueError(f"bad mlagent URI {uri!r}; want mlagent://model/<name>[/<ver>]")
    name = parts[1]
    version = parts[2] if len(parts) > 2 else None
    db = _load_db()
    entry = db.get(name)
    if not entry:
        raise ValueError(f"mlagent: model {name!r} not registered (db: {_db_path()})")
    ver = version or entry.get("active")
    path = entry.get("versions", {}).get(str(ver))
    if not path:
        raise ValueError(f"mlagent: model {name!r} has no version {ver!r}")
    if not os.path.exists(path):
        raise ValueError(f"mlagent: registered path missing: {path}")
    return path
