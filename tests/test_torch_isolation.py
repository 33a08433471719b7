"""The port imports neither JAX/flax/optax/orbax nor the JAX package
(the machine that runs it on the card has none of them).

``nnstreamer_tpu_torch`` starts with ``nnstreamer_tpu``: every check below
matches the module name ``nnstreamer_tpu`` or the prefix
``nnstreamer_tpu.``, never a bare prefix.
"""

import ast
import json
import multiprocessing
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
             if k in ("jax", "flax", "optax", "orbax", "nnstreamer_tpu")
             or k.startswith(("jax.", "jaxlib", "flax.", "optax.", "orbax.",
                              "nnstreamer_tpu.")))
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
    return (module in ("jax", "jaxlib", "flax", "optax", "orbax",
                       "nnstreamer_tpu")
            or module.startswith(("jax.", "jaxlib.", "flax.", "optax.",
                                  "orbax.", "nnstreamer_tpu.")))


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
    assert _forbidden("optax")
    assert _forbidden("orbax.checkpoint")
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


#: the modules of the slice that brought the multi-stream and flow
#: elements, the converter's remaining paths and subplugins, the decoders
#: they feed and the sensor sources
STREAM_MODULES = (
    "nnstreamer_tpu_torch.elements.mux",
    "nnstreamer_tpu_torch.elements.flow",
    "nnstreamer_tpu_torch.elements.sparse",
    "nnstreamer_tpu_torch.elements.repo",
    "nnstreamer_tpu_torch.elements.converter",
    "nnstreamer_tpu_torch.elements.iio_debug",
    "nnstreamer_tpu_torch.elements.platform_sources",
    "nnstreamer_tpu_torch.elements.transform",
    "nnstreamer_tpu_torch.converters",
    "nnstreamer_tpu_torch.converters.flexbuf",
    "nnstreamer_tpu_torch.converters.python3",
    "nnstreamer_tpu_torch.pyscript",
    "nnstreamer_tpu_torch.decoders.tensor_region",
    "nnstreamer_tpu_torch.decoders.flexbuf",
    "nnstreamer_tpu_torch.decoders.octet_stream",
    "nnstreamer_tpu_torch.decoders.direct_video",
    "nnstreamer_tpu_torch.decoders.python3",
)


#: the modules of the slice that brought the planner's transform fusion
#: and residency lane
PLANNER_MODULES = (
    "nnstreamer_tpu_torch.pipeline.planner",
    "nnstreamer_tpu_torch.ops.fusion_stages",
)


#: the modules of the slice that brought on-device training
TRAINING_MODULES = (
    "nnstreamer_tpu_torch.trainers",
    "nnstreamer_tpu_torch.trainers.cuda_trainer",
    "nnstreamer_tpu_torch.parallel.train",
    "nnstreamer_tpu_torch.elements.trainer_element",
    "nnstreamer_tpu_torch.elements.datarepo_elements",
)


#: the modules of the slice that brought the steady loop and the cost
#: model, memory plan and crossing predictor that license it
LOOP_MODULES = (
    "nnstreamer_tpu_torch.analysis.costmodel",
    "nnstreamer_tpu_torch.analysis.memplan",
    "nnstreamer_tpu_torch.analysis.residency",
    "nnstreamer_tpu_torch.analysis.loop",
    "nnstreamer_tpu_torch.analysis.nego",
    "nnstreamer_tpu_torch.ops.steady_loop",
)


#: the modules of the slice that brought the among-device transports:
#: MQTT, HYBRID discovery and gRPC with its protobuf/flatbuf IDLs
TRANSPORT_MODULES = (
    "nnstreamer_tpu_torch.edge.mqtt",
    "nnstreamer_tpu_torch.edge.discovery",
    "nnstreamer_tpu_torch.elements.mqtt_elems",
    "nnstreamer_tpu_torch.elements.grpc_elems",
    "nnstreamer_tpu_torch.rpc",
    "nnstreamer_tpu_torch.rpc.proto",
    "nnstreamer_tpu_torch.rpc.flat",
    "nnstreamer_tpu_torch.converters.protobuf",
    "nnstreamer_tpu_torch.converters.flatbuf",
    "nnstreamer_tpu_torch.decoders.protobuf",
    "nnstreamer_tpu_torch.decoders.flatbuf",
)


#: the modules of the slice that brought the static analyzer, its lint
#: CLI and whole-chain filter→filter fusion
ANALYZER_MODULES = (
    "nnstreamer_tpu_torch.analysis",
    "nnstreamer_tpu_torch.analysis.registry",
    "nnstreamer_tpu_torch.analysis.passes",
    "nnstreamer_tpu_torch.analysis.chain",
    "nnstreamer_tpu_torch.tools",
    "nnstreamer_tpu_torch.tools.validate",
)


#: the modules of the slice that brought the runtime sanitizer, the lock
#: witness, the schedule fuzzer and the fleet and controller passes
SANITIZER_MODULES = (
    "nnstreamer_tpu_torch.analysis.sanitizer",
    "nnstreamer_tpu_torch.analysis.lockwitness",
    "nnstreamer_tpu_torch.testing.schedfuzz",
    "nnstreamer_tpu_torch.analysis.fleet",
    "nnstreamer_tpu_torch.analysis.ctl",
)


#: what a fork server's child runs for one module: it records what of
#: the port, the JAX package and JAX the interpreter held before the
#: import (nothing, or the check means nothing) and what the import
#: brought of the JAX package and JAX
_ALONE = r"""
import json, os, sys
os.chdir({root!r})
sys.path.insert(0, {root!r})

def held(port):
    return sorted(k for k in sys.modules
                  if k in ("jax", "flax", "optax", "orbax", "nnstreamer_tpu")
                  or k.startswith(("jax.", "jaxlib", "flax.", "optax.",
                                   "orbax.", "nnstreamer_tpu."))
                  if port or not k.startswith("nnstreamer_tpu_torch"))

before = held(True)
preloaded = "torch" in sys.modules and "numpy" in sys.modules
import {module}
with open({out!r}, "w") as fh:
    json.dump({{"before": before, "preloaded": preloaded,
               "loaded": held(False)}}, fh)
"""


@pytest.fixture(scope="module")
def fork_server():
    """One fork server for the module, which imports torch and numpy and
    nothing of either package: each module's check forks a child of it,
    a fresh interpreter but for those two imports, instead of paying a
    torch import per module."""
    from multiprocessing import forkserver

    server = forkserver._forkserver
    server._stop()  # a server another file started may hold other imports
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "numpy"])
    yield ctx
    server._stop()
    ctx.set_forkserver_preload([])


def _import_alone(ctx, module, tmp_path):
    out = tmp_path / "alone.json"
    code = _ALONE.format(root=ROOT, module=module, out=str(out))
    child = ctx.Process(target=exec, args=(code, {"__name__": "alone"}))
    child.start()
    child.join(120)
    if child.exitcode is None:
        child.kill()
        child.join()
    assert child.exitcode == 0, f"importing {module} alone failed"
    return json.loads(out.read_text())


def test_fork_server_holds_torch_and_nothing_of_either_package(
        fork_server, tmp_path):
    """The fork server's children start with torch and numpy imported and
    with nothing of the port, the JAX package or JAX."""
    got = _import_alone(fork_server, "os", tmp_path)
    assert got == {"before": [], "preloaded": True, "loaded": []}


@pytest.mark.parametrize("module", SLICE_MODULES + VISION_MODULES
                         + SERVING_MODULES + STREAM_MODULES
                         + PLANNER_MODULES + TRAINING_MODULES
                         + LOOP_MODULES + TRANSPORT_MODULES
                         + ANALYZER_MODULES + SANITIZER_MODULES)
def test_slice_module_alone_loads_no_jax(module, fork_server, tmp_path):
    """Each module, imported alone in an interpreter that holds nothing of
    the port and nothing of JAX (a child of the fork server), pulls in
    neither JAX nor the JAX package (the walk above imports them all
    together, so an import one of them makes would hide behind another)."""
    got = _import_alone(fork_server, module, tmp_path)
    assert got["before"] == [], got
    assert got["loaded"] == [], got
    path = os.path.join(ROOT, *module.split("."))
    path = (os.path.join(path, "__init__.py") if os.path.isdir(path)
            else path + ".py")
    assert not [m for _, m in _imports(path) if _forbidden(m)]


#: the machine with the card has no grpcio, protobuf or flatbuffers: the
#: probe hides them (a None entry in sys.modules makes an import raise),
#: imports the package and every element, then starts each element and
#: subplugin that needs one of them
_HIDDEN_PROBE = r"""
import sys
for name in ("grpc", "google.protobuf", "flatbuffers"):
    sys.modules[name] = None
import nnstreamer_tpu_torch
import nnstreamer_tpu_torch.elements
import nnstreamer_tpu_torch.rpc
from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.pipeline import parse_launch
caps = "other/tensors,format=static,dimensions=4,types=float32"
lines = {
    "src_grpc": "tensor_src_grpc server=true port=0 ! tensor_sink",
    "src_grpc_flat": "tensor_src_grpc server=true port=0 idl=flatbuf "
                     "! tensor_sink",
    "sink_grpc": f"appsrc caps={caps} ! tensor_sink_grpc server=true port=0",
    "dec_protobuf": f"appsrc caps={caps} ! tensor_decoder mode=protobuf "
                    "! tensor_sink",
    "dec_flatbuf": f"appsrc caps={caps} ! tensor_decoder mode=flatbuf "
                   "! tensor_sink",
}
for name, line in lines.items():
    p = parse_launch(line)
    try:
        p.play()
        print(name, "STARTED")
    except Exception as e:
        print(name, type(e).__name__, str(e).replace("\n", " "))
    finally:
        p.stop()
for kind in ("protobuf", "flatbuf"):
    conv = registry.get(registry.CONVERTER, kind)
    try:
        conv()
        print("conv_" + kind, "STARTED")
    except Exception as e:
        print("conv_" + kind, type(e).__name__, str(e))
print("grpc" in sys.modules and sys.modules["grpc"] is None)
"""


def test_port_imports_without_grpc_protobuf_or_flatbuffers():
    """``import nnstreamer_tpu_torch`` and its elements work with grpc,
    google.protobuf and flatbuffers missing; an element or subplugin that
    needs one raises ElementError naming the package when it starts, and
    none falls back to another transport or codec."""
    out = subprocess.run([sys.executable, "-c", _HIDDEN_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    rows = dict(line.split(" ", 1) for line in out.stdout.splitlines()[:-1])
    assert out.stdout.splitlines()[-1] == "True"
    want = {"src_grpc": "grpcio", "src_grpc_flat": "grpcio",
            "sink_grpc": "grpcio", "dec_protobuf": "protobuf",
            "dec_flatbuf": "flatbuffers", "conv_protobuf": "protobuf",
            "conv_flatbuf": "flatbuffers"}
    assert set(rows) == set(want)
    for name, package in want.items():
        assert "STARTED" not in rows[name], name
        assert rows[name].startswith("ElementError") or \
            "ElementError" in rows[name], (name, rows[name])
        assert f"needs the {package} package" in rows[name], (name,
                                                              rows[name])
