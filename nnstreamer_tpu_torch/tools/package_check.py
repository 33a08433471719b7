"""Packaging self-check for the port: build an sdist and a wheel, then run
the port FROM the wheel (counterpart of the JAX package's
``tools/package_check.py``).

Steps (no network, no installs into the environment):
  1. copy the packaging inputs (setup.py, pyproject.toml, MANIFEST.in, the
     two packages, ``native/`` without its build directories) into a
     temporary directory, so nothing is written into the source tree,
     and build ``python -m build --sdist`` and ``--wheel`` there (both
     ``--no-isolation``);
  2. assert the sdist carries ``native/src`` and the port's
     ``nnstreamer_tpu_torch/csrc`` (source installs can compile) and the
     wheel carries the port's core as
     ``nnstreamer_tpu_torch/_native/libnnstpu_torch_core.so`` (setup.py
     builds it with g++ beside the JAX package's core);
  3. unzip the wheel and, in a child process whose ``sys.path`` starts at
     the unpacked wheel (NOT the repo), run one native-core pipeline
     (``native_rt.build()`` takes the bundled core: no ``native/``
     beside the wheel) and one pure-Python pipeline of the port.

Run: ``python -m nnstreamer_tpu_torch.tools.package_check``; prints one
JSON line. Used by tests/test_torch_packaging.py.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile
import zipfile

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: what setup.py, pyproject.toml and MANIFEST.in read
_INPUTS = ("setup.py", "pyproject.toml", "MANIFEST.in", "README.md",
           "BASELINE.md", "MIGRATION.md", "docs", "native", "nnstreamer_tpu",
           "nnstreamer_tpu_torch")

CORE = "nnstreamer_tpu_torch/_native/libnnstpu_torch_core.so"

#: the builds run at low priority, as native_rt's do: background work
#: beside whatever the neighbouring processes measure
_NICE = ["nice", "-n", "10"] if shutil.which("nice") else []

_WHEEL_SMOKE = r"""
import glob, json, os, sys
unpacked = sys.argv[1]
# package root: wheel root (platlib layout) or .data/purelib (pure layout)
roots = [unpacked] + glob.glob(os.path.join(unpacked, "*.data", "*lib"))
unpacked = next(r for r in roots
                if os.path.exists(os.path.join(r, "nnstreamer_tpu_torch",
                                               "__init__.py")))
sys.path.insert(0, unpacked)
import numpy as np
import nnstreamer_tpu_torch  # must resolve from the wheel
from nnstreamer_tpu_torch import native_rt
assert nnstreamer_tpu_torch.__file__.startswith(unpacked), \
    nnstreamer_tpu_torch.__file__

out = {"from_wheel": True}

# the native core from the bundled .so (no native/ sources beside the wheel)
lib_path = native_rt.build()
assert lib_path == native_rt.PACKAGED_CORE, lib_path
p = native_rt.NativePipeline(
    "appsrc name=src caps=other/tensors,format=static,dimensions=4,"
    "types=float32 "
    "! tensor_transform mode=arithmetic option=add:1.0 "
    "! appsink name=out")
p.play()
p.push("src", [np.arange(4, dtype=np.float32)])
got = p.pull("out", timeout=10.0)
assert got is not None
np.testing.assert_allclose(got[0][0].view(np.float32).reshape(-1),
                           np.arange(4, dtype=np.float32) + 1.0)
p.close()
out["native_pipeline"] = True
out["native_lib"] = os.path.relpath(lib_path, unpacked)

# the port's pure-Python pipeline
from nnstreamer_tpu_torch import parse_launch
from nnstreamer_tpu_torch.buffer import Buffer
p = parse_launch(
    "appsrc name=src caps=other/tensors,num-tensors=1,dimensions=4,"
    "types=float32,framerate=0/1 "
    "! tensor_transform mode=arithmetic option=add:1.0 "
    "! tensor_sink name=out")
p.play()
p["src"].push_buffer(Buffer(tensors=[np.arange(4, dtype=np.float32)]))
p["src"].end_of_stream()
assert p.bus.wait_eos(30)
got = p["out"].collected
assert len(got) == 1
np.testing.assert_allclose(np.asarray(got[0].tensors[0]),
                           np.arange(4, dtype=np.float32) + 1.0)
p.stop()
out["python_pipeline"] = True
print(json.dumps(out))
"""


def _ignore(root: str, names):
    """No caches, no build outputs (native/build*, build/, *.egg-info)."""
    return [n for n in names
            if n == "__pycache__" or n.endswith((".pyc", ".egg-info"))
            or (n.startswith("build") and os.path.isdir(os.path.join(root, n))
                and os.path.basename(root) == "native")]


def _copy_inputs(dst: str) -> None:
    os.makedirs(dst)
    for name in _INPUTS:
        src = os.path.join(_REPO, name)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst, name), ignore=_ignore)
        elif os.path.exists(src):
            shutil.copy2(src, os.path.join(dst, name))


def main(argv=None) -> int:
    result = {"ok": False}
    tmp = tempfile.mkdtemp(prefix="nnstpu_torch_pkg_")
    try:
        src = os.path.join(tmp, "src")
        _copy_inputs(src)
        dist = os.path.join(tmp, "dist")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        for flavor in ("--sdist", "--wheel"):
            r = subprocess.run(
                [*_NICE, sys.executable, "-m", "build", flavor,
                 "--no-isolation", "--outdir", dist, src],
                capture_output=True, text=True, env=env, timeout=900)
            if r.returncode != 0:
                result["build_stderr"] = r.stderr[-2000:]
                print(json.dumps(result))
                return 1
        (sdist,) = glob.glob(os.path.join(dist, "*.tar.gz"))
        (whl,) = glob.glob(os.path.join(dist, "*.whl"))
        result["sdist"] = os.path.basename(sdist)
        result["wheel"] = os.path.basename(whl)

        with tarfile.open(sdist) as tf:
            names = tf.getnames()
        result["sdist_has_native_src"] = any(
            n.endswith("native/src/pipeline.cc") for n in names)
        result["sdist_has_torch_csrc"] = all(
            any(n.endswith(f"nnstreamer_tpu_torch/csrc/{f}") for n in names)
            for f in ("torch_ops.cc", "native_exec.cc", "fused_block.cu"))

        with zipfile.ZipFile(whl) as zf:
            wnames = zf.namelist()
            unpacked = os.path.join(tmp, "unpacked")
            zf.extractall(unpacked)
        result["wheel_has_native_lib"] = any(
            n.endswith(CORE) for n in wnames)

        r = subprocess.run(
            [sys.executable, "-c", _WHEEL_SMOKE, unpacked],
            capture_output=True, text=True, env=env, timeout=300,
            cwd=tmp)  # cwd OUTSIDE the repo: no accidental source imports
        if r.returncode != 0:
            result["smoke_stderr"] = r.stderr[-2000:]
            print(json.dumps(result))
            return 1
        result.update(json.loads(r.stdout.strip().splitlines()[-1]))
        result["ok"] = bool(
            result["sdist_has_native_src"] and result["sdist_has_torch_csrc"]
            and result["wheel_has_native_lib"]
            and result.get("from_wheel") and result.get("native_pipeline")
            and result.get("python_pipeline"))
        print(json.dumps(result))
        return 0 if result["ok"] else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
