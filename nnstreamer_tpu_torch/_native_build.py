"""Build the port's native core with a bare ``g++`` (the build half of
``native_rt.py``).

Standard library only, and no import of the package: setup.py loads this
file by its path to bundle the core into a wheel, where an isolated build
has neither numpy nor torch. ``native_rt`` re-exports every name here.

The core, ``libnnstpu_torch_core.so`` (SONAME the same), is built from the
13 sources of ``native/CMakeLists.txt``'s library (not ``pjrt_filter.cc``:
there is no XLA here): one compile per source, all started together, then
one link, into ``build/native_torch/core-<hash>/`` keyed by the sources,
the headers and the flags. A wheel carries it as
``nnstreamer_tpu_torch/_native/``, taken where the sources are absent.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_PKG = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_PKG)
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_ROOT = os.path.join(_REPO, "build", "native_torch")

#: the port's core: file name and SONAME
CORE_NAME = "libnnstpu_torch_core.so"
#: the library's sources as native/CMakeLists.txt lists them, without the
#: optional pjrt_filter.cc
CORE_SOURCES = (
    "tensor.cc", "element.cc", "pipeline.cc", "elements_basic.cc",
    "elements_tensor.cc", "elements_stream.cc", "elements_stream2.cc",
    "elements_sparse.cc", "edge.cc", "elements_flow.cc",
    "elements_decoder.cc", "filter.cc", "capi.cc",
)
CORE_CXXFLAGS = ("-std=c++17", "-O3", "-fPIC")
#: the wheel's copy of the core (setup.py bundles it)
PACKAGED_CORE = os.path.join(_PKG, "_native", CORE_NAME)

#: seconds each build took in this process ("core", "exec", "ops"); absent
#: where the library was built before
build_seconds: Dict[str, float] = {}

#: builds run at low priority: they are background work beside whatever
#: the process and its neighbours measure
_NICE = ["nice", "-n", "10"] if shutil.which("nice") else []


def digest(files: Sequence[str], flags: Sequence[str]) -> str:
    """sha256 (16 hex digits) over ``flags`` and each file's name and
    bytes: the key of a build directory."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in files:
        h.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def compile_shared(out_dir: str, name: str, sources: Sequence[str],
                   cflags: Sequence[str], ldflags: Sequence[str],
                   tag: str, before_link: Optional[Callable[[], object]] = None,
                   reuse: bool = True) -> str:
    """``out_dir/name`` built from ``sources`` with ``g++``: one compile
    per source, all started together, then one link to a temporary name
    and a rename (after ``before_link()``, which makes what the link
    needs). Under a lock file in ``out_dir``; a library already there is
    reused unless ``reuse`` is false. Raises with the compiler's output on
    failure."""
    lib_path = os.path.join(out_dir, name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if reuse and os.path.exists(lib_path):
            return lib_path
        t0 = time.perf_counter()
        procs = []
        for src in sources:
            obj = os.path.join(out_dir,
                               os.path.splitext(os.path.basename(src))[0]
                               + ".o")
            procs.append((src, obj, subprocess.Popen(
                [*_NICE, "g++", *cflags, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for src, _, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{os.path.basename(src)}:\n"
                              + out.decode(errors="replace")[-4000:])
        if errors:
            raise RuntimeError(f"g++ failed building {name}:\n"
                               + "\n".join(errors))
        if before_link is not None:
            before_link()
        tmp = f"{lib_path}.tmp{os.getpid()}"
        link = subprocess.run(
            [*_NICE, "g++", "-shared", "-o", tmp, *[o for _, o, _ in procs],
             *ldflags], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError(f"linking {name} failed:\n"
                               + link.stdout.decode(errors="replace")[-4000:])
        os.replace(tmp, lib_path)
        build_seconds[tag] = time.perf_counter() - t0
    return lib_path


def core_build() -> Tuple[str, List[str], List[str], List[str]]:
    """(output directory, sources, compile flags, link flags) of the core;
    the directory is keyed by the sources, the headers and the flags."""
    src = os.path.join(NATIVE_DIR, "src")
    inc = os.path.join(NATIVE_DIR, "include")
    sources = [os.path.join(src, s) for s in CORE_SOURCES]
    headers = sorted(os.path.join(d, f) for d in (src, os.path.join(
        inc, "nnstpu")) for f in os.listdir(d) if f.endswith((".h", ".hh")))
    cflags = [*CORE_CXXFLAGS, "-I", inc]
    ldflags = ["-pthread", "-ldl", f"-Wl,-soname,{CORE_NAME}"]
    out_dir = os.path.join(BUILD_ROOT, "core-" + digest(
        sources + headers, cflags + ldflags))
    return out_dir, sources, cflags, ldflags


def build() -> str:
    """The port's core, built from ``native/src`` at first use (or the
    wheel's bundled copy where the sources are absent). Returns its
    path."""
    if not os.path.isdir(os.path.join(NATIVE_DIR, "src")):
        if os.path.exists(PACKAGED_CORE):
            return PACKAGED_CORE
        raise RuntimeError(
            "native core sources not present and no wheel-bundled "
            f"{CORE_NAME}: the native pipeline runtime needs a source "
            "checkout with native/ or a wheel built where g++ was available "
            "— see README.md")
    out_dir, sources, cflags, ldflags = core_build()
    return compile_shared(out_dir, CORE_NAME, sources, cflags, ldflags,
                          "core")
