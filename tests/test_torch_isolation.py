"""The port imports neither JAX/flax nor the JAX package.

``nnstreamer_tpu_torch`` starts with ``nnstreamer_tpu``: every check below
matches the module name ``nnstreamer_tpu`` or the prefix
``nnstreamer_tpu.``, never a bare prefix.
"""

import ast
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "nnstreamer_tpu_torch")

_PROBE = r"""
import importlib, pkgutil, sys
import nnstreamer_tpu_torch as p
import chip_smoke  # noqa: F401 — the GPU entry point imports alike
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k in ("jax", "flax", "nnstreamer_tpu")
             or k.startswith(("jax.", "jaxlib", "flax.", "nnstreamer_tpu.")))
print(len(names), bad)
"""


def test_import_every_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 30
    assert bad == "[]", bad


def _forbidden(module: str) -> bool:
    return (module in ("jax", "jaxlib", "flax", "nnstreamer_tpu")
            or module.startswith(("jax.", "jaxlib.", "flax.",
                                  "nnstreamer_tpu.")))


#: a dotted module path written as a string (registry tables, importlib)
_MODULE_STRING = re.compile(r"^[A-Za-z_]\w*(\.\w+)+$")


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imports(path):
    """(line, module) for every import statement and every dotted module
    path written as a string constant in the file."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _MODULE_STRING.match(node.value):
            yield node.lineno, node.value


def test_static_scan_finds_no_jax_import():
    hits = [f"{os.path.relpath(path, ROOT)}:{line}: {mod}"
            for path in _sources() for line, mod in _imports(path)
            if _forbidden(mod)]
    assert not hits, "\n".join(hits)


def test_scan_tells_the_packages_apart():
    assert _forbidden("nnstreamer_tpu.ops")
    assert _forbidden("jax.numpy")
    assert _forbidden("flax")
    assert not _forbidden("nnstreamer_tpu_torch.ops")
    assert not _forbidden("nnstreamer_tpu_torch")
    assert not _forbidden("jaxtyping")


#: the modules of the slice that brought the tracer, the platform probe,
#: the test models and filters and the rest of the basic elements
SLICE_MODULES = (
    "nnstreamer_tpu_torch.trace",
    "nnstreamer_tpu_torch.platform",
    "nnstreamer_tpu_torch.meta",
    "nnstreamer_tpu_torch.models.simple",
    "nnstreamer_tpu_torch.filters.base",
    "nnstreamer_tpu_torch.filters.custom_easy",
    "nnstreamer_tpu_torch.filters.passthrough",
    "nnstreamer_tpu_torch.filters.cuda_filter",
    "nnstreamer_tpu_torch.elements.basic",
    "nnstreamer_tpu_torch.elements.filter",
)

#: the modules of the slice that brought the detection, segmentation and
#: pose models, their device post-process and their decoders
VISION_MODULES = (
    "nnstreamer_tpu_torch.models.ssd_mobilenet",
    "nnstreamer_tpu_torch.models.deeplab_v3",
    "nnstreamer_tpu_torch.models.posenet",
    "nnstreamer_tpu_torch.models.yolov8",
    "nnstreamer_tpu_torch.models.convert",
    "nnstreamer_tpu_torch.ops.detection",
    "nnstreamer_tpu_torch.ops.fused_block",
    "nnstreamer_tpu_torch.decoders.bounding_boxes",
    "nnstreamer_tpu_torch.decoders.detections",
    "nnstreamer_tpu_torch.decoders.rasterfont",
    "nnstreamer_tpu_torch.decoders.image_segment",
    "nnstreamer_tpu_torch.decoders.pose_estimation",
)


#: the modules of the slice that brought the transport, the serving tier
#: and the query elements
SERVING_MODULES = (
    "nnstreamer_tpu_torch.testing.faults",
    "nnstreamer_tpu_torch.edge.protocol",
    "nnstreamer_tpu_torch.edge.tracex",
    "nnstreamer_tpu_torch.edge.ntp",
    "nnstreamer_tpu_torch.edge.handle",
    "nnstreamer_tpu_torch.edge.fleet",
    "nnstreamer_tpu_torch.serving.admission",
    "nnstreamer_tpu_torch.serving.scheduler",
    "nnstreamer_tpu_torch.serving.controller",
    "nnstreamer_tpu_torch.analysis.plant",
    "nnstreamer_tpu_torch.elements.query",
    "nnstreamer_tpu_torch.elements.edge_elems",
)


@pytest.mark.parametrize("module",
                         SLICE_MODULES + VISION_MODULES + SERVING_MODULES)
def test_slice_module_alone_loads_no_jax(module):
    """Each module, imported alone in a fresh interpreter, pulls in
    neither JAX nor the JAX package (the walk above imports them all
    together, so an import one of them makes would hide behind another)."""
    probe = (f"import sys, {module}\n"
             "print(sorted(k for k in sys.modules if k in ('jax', 'flax', "
             "'nnstreamer_tpu') or k.startswith(('jax.', 'jaxlib', 'flax.', "
             "'nnstreamer_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    path = os.path.join(ROOT, *module.split(".")) + ".py"
    assert not [m for _, m in _imports(path) if _forbidden(m)]
