"""The port's packaging: sdist and wheel, then the port run from the wheel.

tools/package_check.py (the port's) builds both from a copy of the
packaging inputs, so the source tree is not written to, and runs one
native-core pipeline (the wheel's bundled libnnstpu_torch_core.so) and one
pure-Python pipeline of the port from the unpacked wheel. This test holds
its verdict, as tests/test_packaging.py holds the JAX package's.

setup.py's step that bundles the port's core is also run alone, in a child
where numpy and torch cannot be imported (as in an isolated wheel build,
whose build requirements are setuptools alone): it bundles the core, and
where the core does not build it says so and goes on.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: setup.py's build_py._bundle_torch_core run alone: setup() is not called,
#: numpy and torch are unimportable; argv: the build_lib directory and
#: "fail" to make the core's build raise
_BUNDLE = r"""
import json, os, runpy, shutil, sys, types
for name in ("numpy", "torch"):
    sys.modules[name] = None
import setuptools
setuptools.setup = lambda **kw: None
g = runpy.run_path(os.path.join(sys.argv[1], "setup.py"))
step = g["build_py_with_native"]._bundle_torch_core
if sys.argv[3] == "fail":
    def failing():
        raise RuntimeError("g++ failed building libnnstpu_torch_core.so")
    step.__globals__["_load_torch_native_build"] = lambda: types.SimpleNamespace(
        build=failing, CORE_NAME="libnnstpu_torch_core.so")
step(types.SimpleNamespace(build_lib=sys.argv[2], copy_file=shutil.copyfile))
print(json.dumps({"numpy": sys.modules.get("numpy") is not None,
                  "torch": sys.modules.get("torch") is not None}))
"""


def test_wheel_and_sdist_roundtrip():
    if importlib.util.find_spec("build") is None:
        pytest.skip("the packaging check needs the 'build' package")
    if shutil.which("g++") is None:
        pytest.skip("the wheel's native core needs g++")
    r = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.tools.package_check"],
        capture_output=True, text=True, timeout=1200,
    )
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["ok"], result
    assert result["sdist_has_native_src"], result
    assert result["sdist_has_torch_csrc"], result
    assert result["wheel_has_native_lib"], result
    assert result["native_pipeline"], result
    assert result["python_pipeline"], result
    assert result["native_lib"] == \
        "nnstreamer_tpu_torch/_native/libnnstpu_torch_core.so", result


@pytest.mark.parametrize("mode", ["builds", "fail"])
def test_setup_bundles_the_core_without_numpy(mode, tmp_path):
    """setup.py's bundling step in a child without numpy and torch: it
    loads the port's build by its path (nnstreamer_tpu_torch/_native_build.py,
    standard library only) and copies the core into the wheel's tree; where
    the core does not build, it prints why and the build goes on without
    it."""
    if shutil.which("g++") is None:
        pytest.skip("the port's core needs g++")
    r = subprocess.run(
        [sys.executable, "-c", _BUNDLE, REPO, str(tmp_path), mode],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == \
        {"numpy": False, "torch": False}
    core = tmp_path / "nnstreamer_tpu_torch" / "_native" / \
        "libnnstpu_torch_core.so"
    if mode == "builds":
        assert core.stat().st_size > 0
    else:
        assert not core.exists()
        assert "did not build" in r.stdout and "g++ failed" in r.stdout
