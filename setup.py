"""Build hooks: bundle the native core (libnnstpu.so) into the wheel.

L8 packaging parity (SURVEY §2 row "packaging / app surface"): the
reference ships distro recipes that build and install its native plugins
(/root/reference/packaging/nnstreamer.spec, debian/). Here the wheel is
the distribution unit: building it compiles `native/` via cmake+ninja
(reusing the in-tree `native/build` cache, same as native_rt.build()) and
packages the shared library as `nnstreamer_tpu/_native/libnnstpu.so`,
which native_rt falls back to when no source checkout is present. If the
native toolchain is unavailable the wheel degrades to pure-Python (the
JAX path is unaffected); the sdist always carries `native/` so source
installs can compile locally.

The PyTorch port (nnstreamer_tpu_torch) keeps a core of its own,
libnnstpu_torch_core.so, built from the same sources with g++ (no cmake);
the wheel bundles it as nnstreamer_tpu_torch/_native/libnnstpu_torch_core.so.
"""

import importlib.util
import os
import shutil
import subprocess

from setuptools import Distribution, setup
from setuptools.command.build_py import build_py

HERE = os.path.dirname(os.path.abspath(__file__))


def _pjrt_include_dir() -> str:
    # mirror of nnstreamer_tpu.native_rt._pjrt_include_dir, inlined so the
    # build does not import the package (package import pulls in jax)
    override = os.environ.get("NNSTPU_PJRT_C_API_INCLUDE")
    if override is not None:
        return override
    try:
        import importlib.util

        spec = importlib.util.find_spec("tensorflow")
        if spec and spec.submodule_search_locations:
            d = os.path.join(
                list(spec.submodule_search_locations)[0], "include",
                "tensorflow", "compiler", "xla", "pjrt", "c",
            )
            if os.path.exists(os.path.join(d, "pjrt_c_api.h")):
                return d
    except Exception:  # noqa: BLE001
        pass
    return ""


class build_py_with_native(build_py):  # noqa: N801 — setuptools convention
    def run(self):
        super().run()
        self._bundle_native()

    def _bundle_native(self):
        native = os.path.join(HERE, "native")
        if not os.path.isdir(os.path.join(native, "src")):
            return  # building from a tree without native sources
        self._bundle_torch_core()
        if not (shutil.which("cmake") and shutil.which("ninja")):
            print("nnstreamer-tpu: cmake/ninja not found — "
                  "building a pure-Python wheel (no native core)")
            return
        build_dir = os.path.join(native, "build")
        subprocess.run(
            ["cmake", "-S", native, "-B", build_dir, "-G", "Ninja",
             "-DCMAKE_BUILD_TYPE=Release",
             f"-DPJRT_C_API_INCLUDE_DIR={_pjrt_include_dir()}"],
            check=True,
        )
        subprocess.run(["ninja", "-C", build_dir], check=True)
        lib = os.path.join(build_dir, "libnnstpu.so")
        dest_dir = os.path.join(self.build_lib, "nnstreamer_tpu", "_native")
        os.makedirs(dest_dir, exist_ok=True)
        self.copy_file(lib, os.path.join(dest_dir, "libnnstpu.so"))

    def _bundle_torch_core(self):
        """The PyTorch port's own core (libnnstpu_torch_core.so, built from
        the same native/src with a bare g++) as nnstreamer_tpu_torch/_native/,
        which the port falls back to when no source checkout is present. If
        it does not build, the wheel carries no core for the port, as it
        carries none for the JAX package without cmake."""
        if not shutil.which("g++"):
            print("nnstreamer-tpu: g++ not found — no native core for "
                  "nnstreamer_tpu_torch")
            return
        try:
            native_build = _load_torch_native_build()
            lib = native_build.build()
        except Exception as e:  # noqa: BLE001 — degrade, as without cmake
            print("nnstreamer-tpu: the native core for nnstreamer_tpu_torch "
                  f"did not build — the wheel carries none ({e})")
            return
        dest_dir = os.path.join(self.build_lib, "nnstreamer_tpu_torch",
                                "_native")
        os.makedirs(dest_dir, exist_ok=True)
        self.copy_file(lib, os.path.join(dest_dir, native_build.CORE_NAME))


def _load_torch_native_build():
    """nnstreamer_tpu_torch/_native_build.py loaded by its path: it needs
    only the standard library, so an isolated build (no numpy, no torch)
    runs it, and the package's __init__ is not imported."""
    path = os.path.join(HERE, "nnstreamer_tpu_torch", "_native_build.py")
    spec = importlib.util.spec_from_file_location(
        "_nnstreamer_tpu_torch_native_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class NativeDistribution(Distribution):
    """Declare an ext module so the wheel is platform-tagged and the
    package (with its bundled .so) lands at the wheel root (platlib),
    not .data/purelib."""

    def has_ext_modules(self):
        return (os.path.isdir(os.path.join(HERE, "native", "src"))
                and bool(shutil.which("cmake") and shutil.which("ninja")
                         or shutil.which("g++")))


setup(cmdclass={"build_py": build_py_with_native},
      distclass=NativeDistribution)
