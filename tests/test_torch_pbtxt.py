"""tools/pbtxt.py through the port (counterpart of tests/test_tools.py's
``TestPbtxt``): the reference's cases on the port's copy, and round trips
through both packages giving the same text. The launch side goes through
each package's own ``parse_launch``, so ``launch_to_pbtxt`` of a line
writes the same nodes, properties and edges in both; the texts are
compared byte for byte."""

import importlib

import numpy as np
import pytest
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)

pytest.importorskip("torch")
pytest.importorskip("jax")

from nnstreamer_tpu_torch.tools import pbtxt  # noqa: E402

PKGS = ["nnstreamer_tpu", "nnstreamer_tpu_torch"]

PBTXT = """
# canonical inference graph
node { element: "appsrc" name: "src"
       property { key: "caps"
                  value: "other/tensors,format=static,dimensions=4,types=float32" } }
node { element: "tensor_transform" name: "t"
       property { key: "mode" value: "arithmetic" }
       property { key: "option" value: "add:1" }
       input: "src" }
node { element: "tensor_sink" name: "out" input: "t" }
"""

FAN_OUT = """
node { element: "appsrc" name: "s" }
node { element: "tee" name: "t" input: "s" }
node { element: "tensor_sink" name: "a" input: "t" }
node { element: "tensor_sink" name: "b" input: "t" }
"""

#: launch lines of the reference's examples, fan-out and fan-in included
LINES = [
    "appsrc name=src caps=other/tensors,format=static,dimensions=4,"
    "types=float32 ! tensor_transform name=t mode=arithmetic option=add:1 "
    "! tensor_sink name=out",
    "appsrc name=s ! tee name=t t. ! queue name=q1 ! tensor_sink name=a "
    "t. ! queue name=q2 ! tensor_sink name=b",
    "appsrc name=a ! tensor_mux name=m sync-mode=nosync ! tensor_sink "
    "name=out appsrc name=b ! m.",
    "appsrc name=src ! tensor_filter name=f framework=jax model=add "
    "custom=k:1 ! tensor_decoder name=d mode=image_labeling "
    "! tensor_sink name=out",
]


def _pbtxt(pkg):
    return importlib.import_module(f"{pkg}.tools.pbtxt")


# -- the reference's cases on the port ------------------------------------

def test_parse():
    nodes = pbtxt.parse_pbtxt(PBTXT)
    assert [n.element for n in nodes] == [
        "appsrc", "tensor_transform", "tensor_sink"]
    assert nodes[1].properties == [("mode", "arithmetic"), ("option", "add:1")]
    assert nodes[2].inputs == ["t"]


def test_to_launch_runs():
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.pipeline import parse_launch

    p = parse_launch(pbtxt.pbtxt_to_launch(PBTXT))
    p.play()
    p["src"].push_buffer(Buffer(tensors=[np.zeros(4, np.float32)]))
    got = p["out"].pull(timeout=5.0)
    p.stop()
    assert got is not None
    np.testing.assert_allclose(np.asarray(got.tensors[0]), 1.0)


def test_fan_out_branches():
    launch = pbtxt.pbtxt_to_launch(FAN_OUT)
    assert "t. !" in launch or launch.count("t.") >= 1


def test_unknown_input_rejected():
    with pytest.raises(ValueError, match="unknown input"):
        pbtxt.pbtxt_to_launch('node { element: "tensor_sink" input: "ghost" }')


def test_bad_grammar_rejected():
    with pytest.raises(ValueError):
        pbtxt.parse_pbtxt("node { element: }")


# -- both packages ---------------------------------------------------------

@pytest.mark.parametrize("text", [PBTXT, FAN_OUT], ids=["chain", "fan_out"])
def test_pbtxt_to_launch_equals_the_jax_package(text):
    assert pbtxt.pbtxt_to_launch(text) == _pbtxt(PKGS[0]).pbtxt_to_launch(
        text)


@pytest.mark.parametrize("line", LINES, ids=["chain", "tee", "mux",
                                             "filter"])
def test_round_trip_gives_the_same_text(line):
    """launch → pbtxt → launch → pbtxt in each package: the same texts
    in both, at each step (the element order of the second text may
    differ from the first's where a fan-in reorders the nodes, in both
    packages alike)."""
    texts = {}
    for pkg in PKGS:
        mod = _pbtxt(pkg)
        first = mod.launch_to_pbtxt(line)
        launch = mod.pbtxt_to_launch(first)
        texts[pkg] = (first, launch, mod.launch_to_pbtxt(launch))
    assert texts[PKGS[1]] == texts[PKGS[0]]
    assert {n.name for n in pbtxt.parse_pbtxt(texts[PKGS[1]][0])} == {
        n.name for n in pbtxt.parse_pbtxt(texts[PKGS[1]][2])}
