"""The compile cache: a filter's program built in a child process, stored on
disk, and loaded by the streaming process (counterpart of the JAX
package's ``filters/aot.py``).

What the JAX cache holds is a serialized XLA executable. Opening this
package's filter costs three things instead, none of which the streaming
process should pay: building the kernel library with ``nvcc``
(ops/_cuda.py), drawing the seed weights or reading the checkpoint, and
folding and casting each BatchNorm into the form the kernels take
(models.mobilenet_v2.fold_state). So a cache entry holds the composed
program's state as the forward computes with it, the composition spec,
and the ``meta`` the JAX package records (model, custom, shapes, spec,
``hbm_bytes``, created). The child (filters/aot_worker.py) builds the
kernel library when ``build/torch_kernels/<hash>/`` lacks it, builds the
model on the device the parent names and folds it there, so a loaded
program is bit-equal to an in-process build on that device. Loading puts
the tensors on the device and rebuilds each model's forward around them
(``restore_folded``): no folding, no seed draw and no ``nvcc`` in the
streaming process. CUDA graphs cannot be stored; the window and launch
depth stay key dimensions and the capture happens after the load.

Entries are ``np.savez`` files (``<key>.nnstpu-torch``): one array per
state tensor (bfloat16 stored as its int16 bits) plus the meta as JSON
bytes, read back with ``allow_pickle=False``, so an entry is data, never
code. The directory checks stay anyway: 0700, a real directory, owned by
this user.

The directory is ``$NNSTPU_AOT_CACHE`` (default
``$XDG_CACHE_HOME/nnstpu-aot``, else ``~/.cache/nnstpu-aot``), the JAX
package's, but this package keeps its entries and its quarantine in the
subdirectory ``torch/``: the JAX package's listing, eviction and purge
walk only the files at the top of the directory, so the two packages can
share one ``NNSTPU_AOT_CACHE`` without evicting or quarantining each
other's entries, and this package never reads the JAX package's.

The key (v2) covers everything that changes the program: the model's
content (sha256 of a file model's bytes), the content of the weights
file a zoo model names (``custom=params:<path>``: an entry holds the
weights themselves, so a file rewritten in place must be a miss), the
custom string, the input signature, the platform, the runtime (torch and
CUDA versions, the driver, the ``sm`` arch, the device name, the kernel
library's digest and the digest of this package's Python that builds or
restores an entry), and the composition spec (fused stage specs, the
chain, the loop window and launch depth, the mesh layout, the
serve-batch placement) — the JAX package's dimensions, which the lint
(analysis/aot.py, NNST970–972) predicts. A loaded entry is only state:
the filter swaps its bundles in and composes around them with its own
code. An unreadable entry is quarantined rather than raised; the cache
is bounded (``NNSTPU_AOT_CACHE_MAX_BYTES``, default 2 GiB) and evicts
the least recently loaded entry first (a load touches st_mtime).
"""

from __future__ import annotations

import functools
import hashlib
import io
import json
import os
import stat
import subprocess
import sys
import time
import zipfile
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from nnstreamer_tpu_torch.log import get_logger

log = get_logger("filter.torch_cuda.aot")

#: compile-worker wall-clock budget (a cold kernel build takes minutes)
WORKER_TIMEOUT_SEC = float(os.environ.get("NNSTPU_AOT_TIMEOUT", "600"))

#: cache-key format version — bump whenever the key blob layout changes
CACHE_VERSION = 2

#: default bound on total cache bytes (NNSTPU_AOT_CACHE_MAX_BYTES)
CACHE_MAX_BYTES_DEFAULT = 2 << 30

#: this package's entries and quarantine, under the shared directory
SUBDIR = "torch"

#: an entry's file suffix
SUFFIX = ".nnstpu-torch"

#: bounded module-level event log (hit/miss/load-ms/compile-ms per call)
#: — doctor --aot renders it; the tracer gets per-element copies via the
#: ``observer`` callback on maybe_aot_compile
EVENTS_KEEP = 256
EVENTS: "deque[Dict[str, Any]]" = deque(maxlen=EVENTS_KEEP)

#: the array in an entry that holds its meta as JSON bytes
_META = "__meta__"


def _check_dir(d: str, named: bool) -> None:
    """A directory whose entries this process loads: a real directory
    (no symlink swap), owned by us, private."""
    st = os.lstat(d)
    if not stat.S_ISDIR(st.st_mode):
        raise RuntimeError(f"AOT cache path {d} is not a directory")
    if hasattr(os, "getuid") and st.st_uid != os.getuid():
        hint = ("NNSTPU_AOT_CACHE must point to a directory owned by the "
                "current user" if named
                else "set NNSTPU_AOT_CACHE to a directory you own")
        raise RuntimeError(
            f"AOT cache dir {d} is owned by uid {st.st_uid}, not us — "
            f"refusing to load entries from it ({hint})")
    if st.st_mode & 0o077:
        raise RuntimeError(
            f"AOT cache dir {d} is group/world-accessible "
            f"(mode {stat.S_IMODE(st.st_mode):o}) — refusing to load "
            "entries from it; purge it and chmod 700, or point "
            "NNSTPU_AOT_CACHE at a private directory")


def base_dir() -> str:
    """The shared cache directory (the JAX package's), validated."""
    d = os.environ.get("NNSTPU_AOT_CACHE")
    named = bool(d)
    if not d:
        base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
            os.path.expanduser("~"), ".cache")
        d = os.path.join(base, "nnstpu-aot")
    os.makedirs(d, mode=0o700, exist_ok=True)
    _check_dir(d, named)
    return d


def cache_dir() -> str:
    """This package's entries: ``torch/`` under :func:`base_dir`, with the
    same checks before any entry in it is trusted."""
    d = os.path.join(base_dir(), SUBDIR)
    os.makedirs(d, mode=0o700, exist_ok=True)
    _check_dir(d, bool(os.environ.get("NNSTPU_AOT_CACHE")))
    return d


def quarantine_dir() -> str:
    """Where unreadable entries go instead of being deleted: keeps the
    evidence for ``doctor --aot`` (NNST972) without ever re-loading it."""
    d = os.path.join(cache_dir(), "quarantine")
    os.makedirs(d, mode=0o700, exist_ok=True)
    return d


def _quarantine(path: str) -> None:
    try:
        os.replace(path, os.path.join(quarantine_dir(),
                                      os.path.basename(path)))
    except OSError:
        try:
            os.unlink(path)
        except OSError:
            pass


#: (abspath, mtime_ns, size) → sha256 hexdigest — re-hash only when the
#: stat changes; the CONTENT hash is what keys the cache (an A→B→A swap
#: restoring identical bytes must hit A's entries again)
_hash_cache: Dict[Tuple[str, int, int], str] = {}


def _content_hash(path: str) -> Optional[str]:
    """sha256 of a file's bytes (a directory: the state file inside it),
    or None when there is no such file; re-hashed only when the stat
    changes."""
    if not os.path.exists(path):
        return None
    if os.path.isdir(path):  # a checkpoint directory
        from nnstreamer_tpu_torch.models import STATE_FILE

        path = os.path.join(path, STATE_FILE)
    ap = os.path.abspath(path)
    st = os.stat(path)
    ck = (ap, st.st_mtime_ns, st.st_size)
    hit = _hash_cache.get(ck)
    if hit is None:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        hit = h.hexdigest()
        _hash_cache[ck] = hit
        if len(_hash_cache) > 64:
            _hash_cache.pop(next(iter(_hash_cache)))
    return hit


def _model_fingerprint(model: str) -> str:
    """Identity of the model source: sha256 of the file BYTES for file
    models (a checkpoint, a ``.py`` file), the name itself for zoo models
    (zoo code rides the runtime fingerprint's ``code`` digest)."""
    hit = _content_hash(model)
    return model if hit is None else f"sha256:{hit}"


def params_fingerprint(custom: str) -> str:
    """sha256 of the weights file ``custom=params:<path>`` names (a file,
    or the trainer's directory), "" without one. The worker bakes those
    weights into the entry, so their content keys it as the model's
    does; a missing file keys on its path, which the custom string
    holds."""
    path = custom_dict(custom.split("|shard=", 1)[0]).get("params")
    if not path:
        return ""
    hit = _content_hash(path)
    return "" if hit is None else f"sha256:{hit}"


#: this package's Python that builds or restores an entry (relative to
#: the package): an edit to any of it must be a miss, as a kernel
#: source's edit is through the library's digest
CODE_FILES = ("models", "ops/fused_block.py", "ops/fusion_stages.py",
              "filters/aot.py", "filters/aot_worker.py",
              "tools/_import_common.py", "tools/onnx_lite.py",
              "tools/import_onnx.py", "tools/tflite_fb.py",
              "tools/import_tflite.py")


def code_digest(root: Optional[str] = None) -> str:
    """sha256 (16 hex digits) over the :data:`CODE_FILES` under ``root``
    (default: this package), each file's path and bytes; a directory
    stands for the ``.py`` files in it."""
    root = root or os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))
    h = hashlib.sha256()
    for rel in CODE_FILES:
        path = os.path.join(root, rel)
        files = (sorted(os.path.join(path, n) for n in os.listdir(path)
                        if n.endswith(".py"))
                 if os.path.isdir(path) else [path])
        for name in files:
            h.update(os.path.relpath(name, root).encode() + b"\0")
            with open(name, "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


_code_digest = functools.lru_cache(maxsize=1)(code_digest)


@functools.lru_cache(maxsize=1)
def _kernels_digest() -> str:
    from nnstreamer_tpu_torch.ops import _cuda

    try:
        return _cuda._digest()
    except OSError:  # no sources beside the package
        return ""


@functools.lru_cache(maxsize=8)
def _card_fingerprint(index: int) -> Dict[str, str]:
    import torch

    out = {}
    try:
        out["driver"] = str(torch._C._cuda_getDriverVersion())
    except Exception:  # noqa: BLE001 — best effort
        out["driver"] = ""
    try:
        major, minor = torch.cuda.get_device_capability(index)
        out["sm"] = f"sm_{major}{minor}"
        out["device_kind"] = torch.cuda.get_device_name(index)
    except Exception:  # noqa: BLE001 — no card: the platform covers it
        out["sm"], out["device_kind"] = "", ""
    return out


def runtime_fingerprint(platform: str = "") -> Dict[str, str]:
    """torch and CUDA versions, the driver, the ``sm`` arch, the device
    name, the kernel library's digest and the digest of the Python that
    builds or restores an entry (:func:`code_digest`): a runtime upgrade,
    a device swap, a kernel edit or an edit to the seed draw or the fold
    must be a MISS, not a wrong program."""
    import torch

    out = {"torch": torch.__version__, "cuda": str(torch.version.cuda),
           "kernels": _kernels_digest(), "code": _code_digest()}
    if platform.startswith("cuda"):
        index = int(platform.split(":", 1)[1]) if ":" in platform else 0
        out.update(_card_fingerprint(index))
    else:
        out.update(driver="", sm="", device_kind=platform or "cpu")
    return out


def platform_of(device) -> str:
    """The key's platform for a torch device: ``cuda`` or ``cpu`` (one
    card's index rides the runtime fingerprint's device name)."""
    return str(getattr(device, "type", device) or "cpu")


def cache_key(
    model: str,
    custom: str,
    shapes: Sequence[Tuple[Tuple[int, ...], str]],
    platform: str,
    spec: Optional[dict] = None,
) -> str:
    """v2 key over the FULL resolved execution spec. ``spec`` carries the
    planner-resolved composition dims (absent keys = solo program):
    ``donate``, ``stages_pre``/``stages_post`` (fused elementwise specs),
    ``chain`` (fused downstream composition), ``loop_window`` +
    ``launch_depth``, ``mesh`` (a ``|shard=<json>`` suffix of the custom
    string, as the JAX package keys it), ``serve_batch``/``placement``
    (replica pool). The content of a ``params:`` file rides beside the
    model's (:func:`params_fingerprint`)."""
    doc = {
        "model": _model_fingerprint(model),
        "custom": custom,
        "shapes": [[list(s), d] for s, d in shapes],
        "platform": platform,
        "runtime": runtime_fingerprint(platform),
        "spec": spec or {},
        "v": CACHE_VERSION,
    }
    params = params_fingerprint(custom)
    if params:
        doc["params"] = params
    blob = json.dumps(doc, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def cache_path(key: str) -> str:
    return os.path.join(cache_dir(), f"{key}{SUFFIX}")


# --------------------------------------------------------------------------
# the entry format
# --------------------------------------------------------------------------

def write_entry(path: str, arrays: Dict[str, Any], meta: dict) -> None:
    """Write an entry atomically: ``arrays`` (name → tensor or array) as
    one npz with the meta as JSON bytes. A bfloat16 tensor is stored as
    its int16 bits, its dtype in ``meta["dtypes"]``."""
    import torch

    out: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for k, v in arrays.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().contiguous()
            if v.dtype == torch.bfloat16:
                dtypes[k] = "bfloat16"
                v = v.view(torch.int16)
            v = v.numpy()
        out[k] = np.ascontiguousarray(v)
    meta = dict(meta, dtypes=dtypes)
    out[_META] = np.frombuffer(json.dumps(meta, sort_keys=True).encode(),
                               dtype=np.uint8)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **out)
    os.replace(tmp, path)


def _read(path: str, arrays: bool = True):
    """(meta, {name: tensor on the CPU}) of an entry; raises when it is
    unreadable. Never unpickles."""
    import torch

    with open(path, "rb") as f:
        data = f.read()
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        meta = json.loads(bytes(z[_META]).decode())
        if not arrays:
            return meta, {}
        dtypes = meta.get("dtypes") or {}
        out = {}
        for k in z.files:
            if k == _META:
                continue
            t = torch.from_numpy(np.array(z[k]))
            if dtypes.get(k) == "bfloat16":
                t = t.view(torch.bfloat16)
            out[k] = t
    return meta, out


def entry_meta(path: str) -> Optional[dict]:
    """The ``meta`` dict of a cache entry (model/custom/shapes/spec/
    hbm_bytes/created), or None when unreadable."""
    try:
        return dict(_read(path, arrays=False)[0])
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None


class Program:
    """A loaded entry: the head model's bundle and each chain tail's (by
    the tail's index in the spec's chain), rebuilt on ``device`` from the
    entry's state. The filter swaps them in and composes around them with
    its own code, as it does in process."""

    def __init__(self, meta: dict, arrays: Dict[str, Any], device):
        import torch

        self.meta = meta
        self.device = torch.device(device)
        self.head = _restore(meta, "head", meta["model"],
                             custom_dict(meta["custom"]), arrays, self.device)
        chain = (meta.get("spec") or {}).get("chain") or []
        self.tails = {
            i: _restore(meta, f"chain.{i}", payload["model"],
                        custom_dict(payload.get("custom", "")), arrays,
                        self.device)
            for i, (kind, payload) in enumerate(chain) if kind == "model"}


def custom_dict(custom: str) -> Dict[str, str]:
    """The custom string parsed as the filter parses it."""
    from nnstreamer_tpu_torch.filters.base import FilterProperties

    return FilterProperties(custom=custom or "").custom_dict()


def _restore(meta: dict, name: str, model: str, custom: Dict[str, str],
             arrays: Dict[str, Any], device):
    """One model's bundle from its part of the entry."""
    from nnstreamer_tpu_torch.models import (
        build_bundle,
        build_with_state,
        restore_folded,
    )

    prog = (meta.get("programs") or {}).get(name) or {}
    pre = name + "/"
    state = {k[len(pre):]: v.to(device) for k, v in arrays.items()
             if k.startswith(pre)}
    form = prog.get("form", "none")
    if form == "folded":
        return restore_folded(prog["recipe"], state, custom, device)
    if form == "state":
        return build_with_state(model, custom, device, state)
    return build_bundle(model, custom, device)


def load(path: str, device=None, budget_bytes: Optional[int] = None):
    """Load a cached program into THIS process on ``device`` (default: the
    card, see :func:`default_device`). Returns a :class:`Program` or
    None. ``budget_bytes`` is the memplan gate: an entry whose recorded
    ``hbm_bytes`` exceeds it is REFUSED (a miss, not an out-of-memory
    error at PLAYING). An unreadable entry is quarantined instead of
    raising."""
    program, _reason = _load(path, device, budget_bytes)
    return program


def default_device():
    """The device of a call that names none: the card, which must exist
    (as the filter's ``pick_device``). The CPU runs only when the caller
    passes it."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "the compile cache (filters/aot.py) builds and loads on a CUDA "
            "device and torch sees none; pass device='cpu' to use the CPU")
    return torch.device("cuda")


def _load(path: str, device=None, budget_bytes: Optional[int] = None):
    """(program_or_None, reason) — reason is None on success, else
    ``"refused-budget"`` or ``"quarantined"``."""
    device = device if device is not None else default_device()
    try:
        meta, _ = _read(path, arrays=False)
        if budget_bytes is not None:
            est = int(meta.get("hbm_bytes", 0) or 0)
            if est > int(budget_bytes):
                log.warning(
                    "AOT cache hit %s refused: estimated %.1f MiB exceeds "
                    "the live per-device budget %.1f MiB — treating as a "
                    "miss", path, est / 2**20, int(budget_bytes) / 2**20)
                return None, "refused-budget"
        meta, arrays = _read(path)
        program = Program(meta, arrays, device)
        try:
            os.utime(path)  # st_mtime = last-loaded → LRU eviction order
        except OSError:
            pass
        return program, None
    except Exception as e:  # noqa: BLE001 — stale/corrupt cache entries
        log.warning("AOT cache entry %s unusable (%s); quarantined, "
                    "recompiling", path, e)
        _quarantine(path)
        return None, "quarantined"


# --------------------------------------------------------------------------
# housekeeping: bounded cache, entry listing, purge
# --------------------------------------------------------------------------

def cache_max_bytes() -> int:
    env = os.environ.get("NNSTPU_AOT_CACHE_MAX_BYTES")
    if env:
        try:
            return max(0, int(env))
        except ValueError:
            log.warning("bad NNSTPU_AOT_CACHE_MAX_BYTES=%r; using default",
                        env)
    return CACHE_MAX_BYTES_DEFAULT


def cache_entries() -> List[Dict[str, Any]]:
    """Live entries (quarantine excluded), least-recently-loaded first:
    key, size, created/last-load timestamps, and the key dims recorded in
    meta (model, custom, shapes, spec). ``doctor --aot`` renders this."""
    d = cache_dir()
    out: List[Dict[str, Any]] = []
    for name in os.listdir(d):
        path = os.path.join(d, name)
        if not os.path.isfile(path):
            continue
        try:
            st = os.stat(path)
        except OSError:
            continue
        row: Dict[str, Any] = {
            "key": name.split(".", 1)[0], "file": name, "path": path,
            "size": int(st.st_size), "last_load": float(st.st_mtime),
        }
        if name.endswith(SUFFIX):
            meta = entry_meta(path) or {}
            row.update({
                "model": meta.get("model"), "custom": meta.get("custom"),
                "shapes": meta.get("shapes"), "spec": meta.get("spec"),
                "hbm_bytes": meta.get("hbm_bytes"),
                "created": meta.get("created"),
                "meta_ok": bool(meta),
            })
        out.append(row)
    out.sort(key=lambda r: (r["last_load"], r["file"]))
    return out


def quarantined_entries() -> List[str]:
    q = os.path.join(cache_dir(), "quarantine")
    if not os.path.isdir(q):
        return []
    return sorted(os.listdir(q))


def enforce_cache_budget() -> int:
    """Evict least-recently-LOADED entries until the cache fits
    ``NNSTPU_AOT_CACHE_MAX_BYTES``; returns the number evicted. Runs
    after every worker compile — the write path, not the hot load path."""
    budget = cache_max_bytes()
    rows = cache_entries()
    total = sum(r["size"] for r in rows)
    evicted = 0
    for r in rows:  # least-recently-loaded first
        if total <= budget:
            break
        try:
            os.unlink(r["path"])
        except OSError:
            continue
        total -= r["size"]
        evicted += 1
        log.info("AOT cache evicted %s (%.1f MiB, least recently loaded)",
                 r["file"], r["size"] / 2**20)
    return evicted


def purge_cache(include_quarantine: bool = True) -> int:
    """Remove every entry of this package (``doctor --aot-purge``);
    returns the count. The JAX package's entries stay."""
    removed = 0
    d = cache_dir()
    for name in os.listdir(d):
        path = os.path.join(d, name)
        if os.path.isfile(path):
            try:
                os.unlink(path)
                removed += 1
            except OSError:
                pass
    q = os.path.join(d, "quarantine")
    if include_quarantine and os.path.isdir(q):
        for name in os.listdir(q):
            try:
                os.unlink(os.path.join(q, name))
                removed += 1
            except OSError:
                pass
    return removed


def _record(event: Dict[str, Any], observer=None) -> Dict[str, Any]:
    EVENTS.append(event)
    if observer is not None:
        try:
            observer(dict(event))
        except Exception:  # noqa: BLE001 — observability must not break AOT
            pass
    return event


# --------------------------------------------------------------------------
# compile + load pipeline
# --------------------------------------------------------------------------

def compile_in_subprocess(
    model: str,
    custom: str,
    shapes: Sequence[Tuple[Tuple[int, ...], str]],
    key: str,
    shard: Optional[dict] = None,
    spec: Optional[dict] = None,
    hbm_bytes: Optional[int] = None,
    device=None,
) -> Optional[str]:
    """Run the compile worker; returns the cache path on success. The
    child builds on ``device`` (the card it names, or the CPU) beside the
    parent. ``spec`` ships the planner composition (fused stages, chain,
    loop window) for the worker to rebuild; ``hbm_bytes`` is the parent's
    footprint estimate, recorded in the entry meta for the memplan hit
    gate."""
    path = cache_path(key)
    if os.path.exists(path):
        return path
    device = device if device is not None else default_device()
    wspec = {"model": model, "custom": custom,
             "shapes": [[list(s), d] for s, d in shapes],
             "device": str(device), "out": path}
    if shard:
        wspec["shard"] = shard
    if spec:
        wspec["spec"] = spec
    if hbm_bytes is not None:
        wspec["hbm_bytes"] = int(hbm_bytes)
    out = _run_worker(wspec, path, "AOT compile")
    if out is not None:
        try:
            enforce_cache_budget()
        except Exception:  # noqa: BLE001 — housekeeping must not fail AOT
            pass
    return out


def _pythonpath() -> str:
    """The child must import the same nnstreamer_tpu_torch."""
    import nnstreamer_tpu_torch

    pkg_parent = os.path.dirname(os.path.dirname(
        os.path.abspath(nnstreamer_tpu_torch.__file__)))
    cur = os.environ.get("PYTHONPATH", "")
    return f"{pkg_parent}{os.pathsep}{cur}" if cur else pkg_parent


#: the last worker's own report (its build, fold and write ms)
LAST_WORKER: Dict[str, Any] = {}


def _run_worker(spec: dict, path: str, tag: str) -> Optional[str]:
    """Run the compile worker on a JSON spec; returns ``path`` when the
    entry exists afterwards, logging the stderr tail otherwise."""
    try:
        res = subprocess.run(
            [sys.executable, "-m", "nnstreamer_tpu_torch.filters.aot_worker"],
            input=json.dumps(spec), capture_output=True, text=True,
            timeout=WORKER_TIMEOUT_SEC,
            env=dict(os.environ, PYTHONPATH=_pythonpath()),
        )
    except subprocess.TimeoutExpired:
        log.warning("%s worker timed out after %.0fs for %s", tag,
                    WORKER_TIMEOUT_SEC, spec["model"])
        return None
    if res.returncode != 0 or not os.path.exists(path):
        tail = (res.stderr or "").strip().splitlines()[-3:]
        log.warning("%s worker failed for %s: %s", tag, spec["model"],
                    " | ".join(tail))
        return None
    LAST_WORKER.clear()
    try:
        LAST_WORKER.update(json.loads(res.stdout.strip().splitlines()[-1]))
    except (ValueError, IndexError):
        pass
    return path


def _key_for(model, custom, shapes, shard, spec, device) -> str:
    key_custom = custom
    if shard:
        key_custom += "|shard=" + json.dumps(shard, sort_keys=True)
    return cache_key(model, key_custom, shapes, platform_of(device),
                     spec=spec)


def _event(model, key, shapes, spec) -> Dict[str, Any]:
    return {"model": model, "key": key,
            "sig": [[list(s), d] for s, d in shapes],
            "spec": dict(spec) if spec else {},
            "outcome": "", "load_ms": 0.0, "compile_ms": 0.0}


def prefetch_compile(
    model: str,
    custom: str,
    shapes: Sequence[Tuple[Tuple[int, ...], str]],
    shard: Optional[dict] = None,
    spec: Optional[dict] = None,
    observer=None,
    device=None,
) -> bool:
    """Warm the cache entry for a program WITHOUT loading it: the
    reload-model / fallback-swap paths call this for model B while model
    A still serves, so B's first invoke after the swap is a load, not a
    build. Returns True when the entry exists afterwards."""
    device = device if device is not None else default_device()
    key = _key_for(model, custom, shapes, shard, spec, device)
    ev = _event(model, key, shapes, spec)
    if os.path.exists(cache_path(key)):
        ev["outcome"] = "prefetch-hit"
        _record(ev, observer)
        return True
    t0 = time.monotonic()
    path = compile_in_subprocess(model, custom, shapes, key, shard=shard,
                                 spec=spec, device=device)
    ev["compile_ms"] = (time.monotonic() - t0) * 1e3
    ev["outcome"] = ("prefetch-compiled" if path is not None
                     else "prefetch-failed")
    _record(ev, observer)
    return path is not None


def maybe_aot_compile(
    model: str,
    custom: str,
    shapes: Sequence[Tuple[Tuple[int, ...], str]],
    shard: Optional[dict] = None,
    device=None,
    spec: Optional[dict] = None,
    budget_bytes: Optional[int] = None,
    hbm_bytes: Optional[int] = None,
    observer=None,
) -> Optional[Program]:
    """Full pipeline: key → cache hit or worker compile → load. Returns a
    :class:`Program` on ``device`` or None to fall back to the in-process
    build.

    ``shard`` (``{"mode": "dp|tp|dpxtp", "shard_devices": N,
    "tp_devices": T}``) keys a MESH program: the worker checks the same
    mesh over its own devices; the filter places the loaded state over
    the mesh. ``spec`` is the planner-resolved composition (see
    :func:`cache_key`) — both keyed AND shipped to the worker.
    ``budget_bytes`` gates hits through memplan's live budget;
    ``hbm_bytes`` is this program's footprint estimate recorded on
    compile. ``observer(event)`` receives the outcome record
    (hit/miss/load-ms/compile-ms) for the tracer."""
    device = device if device is not None else default_device()
    key = _key_for(model, custom, shapes, shard, spec, device)
    path = cache_path(key)
    ev = _event(model, key, shapes, spec)
    if os.path.exists(path):
        t0 = time.monotonic()
        program, reason = _load(path, device, budget_bytes)
        ev["load_ms"] = (time.monotonic() - t0) * 1e3
        if program is not None:
            ev["outcome"] = "hit"
            _record(ev, observer)
            return program
        if reason == "refused-budget":
            # recompiling will not shrink the program — build in process
            # (memplan already billed its footprint against the budget)
            ev["outcome"] = "refused-budget"
            _record(ev, observer)
            return None
        # quarantined/corrupt: fall through to a fresh worker compile
    t0 = time.monotonic()
    path = compile_in_subprocess(model, custom, shapes, key, shard=shard,
                                 spec=spec, hbm_bytes=hbm_bytes,
                                 device=device)
    ev["compile_ms"] = (time.monotonic() - t0) * 1e3
    if path is None:
        ev["outcome"] = "miss-failed"
        _record(ev, observer)
        return None
    t0 = time.monotonic()
    program, reason = _load(path, device, budget_bytes)
    ev["load_ms"] = (time.monotonic() - t0) * 1e3
    ev["outcome"] = ("miss-compiled" if program is not None
                     else f"miss-{reason or 'failed'}")
    _record(ev, observer)
    return program
