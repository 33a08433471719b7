"""The port's gRPC elements and protobuf/flatbuf IDLs (``rpc/``,
``elements/grpc_elems.py``, the four converter and decoder subplugins)
against the JAX package's, on the CPU.

- ``tests/test_grpc.py``'s cases through the port: the protobuf and
  flexbuffers frame round trips (names, rate, bfloat16, corrupt and
  mismatched payloads refused), the decoder-to-converter pipelines, and
  the gRPC elements in both topologies and both IDLs.
- The port's bytes equal the JAX package's encoders' and the committed
  goldens ``tests/golden/frame.pb.bin`` and ``frame.flex.bin``, for numpy
  arrays and for torch tensors (bfloat16 included, through the types
  mapping's ``ml_dtypes``).
- The gRPC elements across packages: each package's tensor_sink_grpc
  into the other's tensor_src_grpc, server and client either side.

The machine with the card has no grpcio, protobuf or flatbuffers: this
file runs where they are installed, and tests/test_torch_isolation.py
checks that the port imports without them. Servers bind ``port=0``.
"""

import os
import time

import numpy as np
import pytest

pytest.importorskip("grpc")
torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")

import ml_dtypes  # noqa: E402

from nnstreamer_tpu import pipeline as jpipeline  # noqa: E402
from nnstreamer_tpu.buffer import Buffer as JBuffer  # noqa: E402
from nnstreamer_tpu.rpc import flat as jflat  # noqa: E402
from nnstreamer_tpu.rpc import proto as jproto  # noqa: E402
from nnstreamer_tpu.types import TensorsConfig as JConfig  # noqa: E402
from nnstreamer_tpu.types import TensorsInfo as JInfo  # noqa: E402
from nnstreamer_tpu_torch import pipeline as tpipeline  # noqa: E402
from nnstreamer_tpu_torch import registry  # noqa: E402
from nnstreamer_tpu_torch.buffer import Buffer as TBuffer  # noqa: E402
from nnstreamer_tpu_torch.rpc import flat as tflat  # noqa: E402
from nnstreamer_tpu_torch.rpc import proto as tproto  # noqa: E402
from nnstreamer_tpu_torch.types import TensorInfo  # noqa: E402
from nnstreamer_tpu_torch.types import TensorsConfig, TensorsInfo  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
PKG = {"jax": (jpipeline, JBuffer), "port": (tpipeline, TBuffer)}


def _golden(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


# -- tests/test_grpc.py through the port -----------------------------------

def test_proto_round_trip():
    buf = TBuffer(tensors=[np.arange(12, dtype=np.float32).reshape(3, 4),
                           np.array([7], dtype=np.int64)], pts=123)
    back, cfg = tproto.frame_from_bytes(tproto.frame_to_bytes(buf))
    assert back.pts == 123 and cfg.info.num_tensors == 2
    np.testing.assert_array_equal(back.tensors[0], buf.tensors[0])
    np.testing.assert_array_equal(back.tensors[1], buf.tensors[1])


def test_proto_with_config_names():
    info = TensorsInfo.from_strings("4:3", "float32", names="feat")
    cfg = TensorsConfig(info=info, rate_n=30, rate_d=1)
    buf = TBuffer(tensors=[np.ones((3, 4), np.float32)])
    _, cfg2 = tproto.frame_from_bytes(tproto.frame_to_bytes(buf, cfg))
    assert cfg2.rate_n == 30 and cfg2.rate_d == 1
    assert cfg2.info[0].name == "feat" and cfg2.info[0].dims == (4, 3)


def test_proto_bfloat16():
    x = np.asarray([1.5, -2.0], dtype=ml_dtypes.bfloat16)
    back, cfg = tproto.frame_from_bytes(tproto.frame_to_bytes(
        TBuffer(tensors=[x])))
    assert cfg.info[0].dtype.value == "bfloat16"
    np.testing.assert_array_equal(back.tensors[0].view(np.uint16),
                                  x.view(np.uint16))


def test_proto_corrupt_payload_rejected():
    m = tproto.TensorFrameMsg()
    m.ParseFromString(tproto.frame_to_bytes(
        TBuffer(tensors=[np.zeros(4, np.float32)])))
    m.tensor[0].data = m.tensor[0].data[:-2]  # truncated payload
    with pytest.raises(ValueError, match="payload"):
        tproto.frame_from_bytes(m.SerializeToString())


def test_flat_round_trip():
    buf = TBuffer(tensors=[np.arange(6, dtype=np.int16).reshape(2, 3)], pts=9)
    back, cfg = tflat.frame_from_flex(tflat.frame_to_flex(buf))
    assert back.pts == 9 and cfg.info[0].dtype.value == "int16"
    np.testing.assert_array_equal(back.tensors[0], buf.tensors[0])


def test_flat_size_mismatch_rejected():
    cfg = TensorsConfig(info=TensorsInfo.from_strings("8", "float64"))
    buf = TBuffer(tensors=[np.zeros(4, np.float64)])  # 4 values, dims say 8
    with pytest.raises(ValueError):
        tflat.frame_from_flex(tflat.frame_to_flex(buf, cfg))


@pytest.mark.parametrize("idl,caps,x", [
    ("protobuf", "dimensions=4,types=float32", np.arange(4, dtype=np.float32)),
    ("flatbuf", "dimensions=2:3,types=uint8",
     np.arange(6, dtype=np.uint8).reshape(3, 2)),
])
def test_decoder_converter_pipeline_round_trip(idl, caps, x):
    """tensors -> tensor_decoder mode=<idl> -> bytes -> tensor_converter
    (the <idl> subplugin, by media type) -> tensors."""
    p1 = tpipeline.parse_launch(
        f"appsrc name=src caps=other/tensors,format=static,{caps} "
        f"! tensor_decoder mode={idl} ! tensor_sink name=out")
    p1.play()
    p1["src"].push_buffer(TBuffer(tensors=[x]))
    encoded = p1["out"].pull(timeout=5.0)
    p1.stop()
    assert encoded is not None
    p2 = tpipeline.parse_launch(
        f"appsrc name=src caps=other/{idl}-tensor ! tensor_converter "
        "! tensor_sink name=out")
    p2.play()
    p2["src"].push_buffer(TBuffer(tensors=[bytes(encoded.tensors[0])]))
    back = p2["out"].pull(timeout=5.0)
    p2.stop()
    assert back is not None
    np.testing.assert_array_equal(np.asarray(back.tensors[0]), x)


def _grpc_pair(pkg_a, line_a, name_a, pkg_b, line_b, push_into, frames,
               eos=False):
    """Play line A, read its bound port, play line B at that port, push
    ``frames`` into the appsrc of the pipeline ``push_into`` names
    ('a' or 'b'), and pull as many outputs from the other's
    tensor_sink."""
    pa = PKG[pkg_a][0].parse_launch(line_a)
    pa.play()
    pb = None
    try:
        port = pa[name_a].bound_port
        pb = PKG[pkg_b][0].parse_launch(line_b.format(port=port))
        pb.play()
        src, out = (pa, pb) if push_into == "a" else (pb, pa)
        buf_cls = PKG[pkg_a if push_into == "a" else pkg_b][1]
        time.sleep(0.3)  # the client's stream attaches
        for f in frames:
            src["src"].push_buffer(buf_cls(tensors=[f]))
        if eos:
            src["src"].end_of_stream()
        got = [out["out"].pull(timeout=10.0) for _ in frames]
    finally:
        if pb is not None:
            pb.stop()
        pa.stop()
    assert all(g is not None for g in got)
    return [np.asarray(g.tensors[0]) for g in got]


def test_sink_server_to_src_client():
    """Pipeline A serves its output; pipeline B pulls it (RecvFrames)."""
    frames = [np.full(4, i, np.float32) for i in range(3)]
    got = _grpc_pair(
        "port", "appsrc name=src caps=other/tensors,format=static,"
        "dimensions=4,types=float32 ! tensor_sink_grpc name=gs server=true "
        "port=0", "gs",
        "port", "tensor_src_grpc name=gr server=false port={port} "
        "! tensor_sink name=out", "a", frames)
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, f)


def test_src_server_from_sink_client():
    """Pipeline A serves an ingest port; pipeline B pushes to it."""
    frames = [np.array([i, i + 1], np.int32) for i in range(3)]
    got = _grpc_pair(
        "port", "tensor_src_grpc name=gr server=true port=0 "
        "! tensor_sink name=out", "gr",
        "port", "appsrc name=src caps=other/tensors,format=static,"
        "dimensions=2,types=int32 ! tensor_sink_grpc name=gs server=false "
        "port={port}", "b", frames, eos=True)
    np.testing.assert_array_equal(got[2], [2, 3])


def test_flatbuf_idl_transport():
    x = np.array([1.0, 2.5, -3.0])
    got = _grpc_pair(
        "port", "tensor_src_grpc name=gr server=true port=0 idl=flatbuf "
        "! tensor_sink name=out", "gr",
        "port", "appsrc name=src caps=other/tensors,format=static,"
        "dimensions=3,types=float64 ! tensor_sink_grpc name=gs server=false "
        "port={port} idl=flatbuf", "b", [x])
    np.testing.assert_array_equal(got[0], x)


# -- wire bytes: the JAX package's and the goldens ---------------------------

@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy", "torch"])
@pytest.mark.parametrize("idl,golden", [("protobuf", "frame.pb.bin"),
                                        ("flatbuf", "frame.flex.bin")])
def test_encoders_match_the_goldens(idl, golden, as_torch):
    """tests/golden/generate.py's wire frame, encoded by the port."""
    arr = np.random.default_rng(7).integers(-100, 100, (3, 4),
                                            dtype=np.int16)
    info = TensorInfo(dims=(4, 3), dtype="int16", name="g")
    cfg = TensorsConfig(info=TensorsInfo(tensors=[info]), rate_n=30,
                        rate_d=1)
    t = torch.from_numpy(arr) if as_torch else arr
    enc = tproto.frame_to_bytes if idl == "protobuf" else tflat.frame_to_flex
    assert enc(TBuffer(tensors=[t], pts=42), cfg) == _golden(golden)


def _cases():
    rng = np.random.default_rng(11)
    bf = rng.normal(size=(2, 5)).astype(ml_dtypes.bfloat16)
    return {
        "float32_pts": ([rng.normal(size=(3, 4)).astype(np.float32)], 5,
                        None),
        "two_tensors": ([rng.integers(0, 256, (2, 3, 3)).astype(np.uint8),
                         np.arange(7, dtype=np.int64)], -1, None),
        "bfloat16": ([bf], 9, None),
        "bfloat16_config": ([bf], 9, ("5:2", "bfloat16", "h")),
        "raw_bytes": ([b"\x01\x02\x03\x04"], 3, None),
        "static_config": ([np.ones((2, 4), np.float32)], 0,
                          ("4:2", "float32", "feat")),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
@pytest.mark.parametrize("idl", ["protobuf", "flatbuf"])
def test_encoders_byte_equal_to_jax(idl, case):
    """The same frame encodes to the same bytes in both packages; a torch
    tensor (bfloat16 through ml_dtypes) to its numpy twin's; each
    package decodes the other's bytes to equal arrays."""
    tensors, pts, cfg = _cases()[case]
    tcfg = jcfg = None
    if cfg is not None:
        dims, dtype, name = cfg
        tcfg = TensorsConfig(info=TensorsInfo.from_strings(
            dims, dtype, names=name), rate_n=15, rate_d=2)
        jcfg = JConfig(info=JInfo.from_strings(dims, dtype, names=name),
                       rate_n=15, rate_d=2)
    jenc, tenc = ((jproto.frame_to_bytes, tproto.frame_to_bytes)
                  if idl == "protobuf" else
                  (jflat.frame_to_flex, tflat.frame_to_flex))
    jdec, tdec = ((jproto.frame_from_bytes, tproto.frame_from_bytes)
                  if idl == "protobuf" else
                  (jflat.frame_from_flex, tflat.frame_from_flex))
    want = jenc(JBuffer(tensors=list(tensors), pts=pts), jcfg)
    assert tenc(TBuffer(tensors=list(tensors), pts=pts), tcfg) == want

    def torched(t):
        if isinstance(t, bytes):
            return t
        if t.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(t.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(t)

    assert tenc(TBuffer(tensors=[torched(t) for t in tensors], pts=pts),
                tcfg) == want
    (tb, tc), (jb, jc) = tdec(want), jdec(want)
    assert tb.pts == jb.pts == pts
    assert tc.info.num_tensors == jc.info.num_tensors == len(tensors)
    for a, b in zip(tb.tensors, jb.tensors):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_subplugins_are_registered():
    assert {"protobuf", "flatbuf"} <= set(registry.available(
        registry.CONVERTER))
    assert {"protobuf", "flatbuf"} <= set(registry.available(
        registry.DECODER))
    for kind in (registry.CONVERTER, registry.DECODER):
        for name in ("protobuf", "flatbuf"):
            assert registry.get(kind, name) is not None


@pytest.mark.parametrize("idl", ["protobuf", "flatbuf"])
def test_decoder_bytes_equal_across_packages(idl):
    """tensor_decoder mode=<idl> in each package on the same frame: the
    same bytes, which the other package's converter turns back."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    caps = "other/tensors,format=static,dimensions=4:3,types=float32"
    enc = {}
    for pkg, (mod, buf_cls) in PKG.items():
        p = mod.parse_launch(f"appsrc name=src caps={caps} ! tensor_decoder "
                             f"mode={idl} ! tensor_sink name=out")
        p.play()
        p["src"].push_buffer(buf_cls(tensors=[x], pts=4))
        got = p["out"].pull(timeout=5.0)
        p.stop()
        enc[pkg] = bytes(got.tensors[0])
    assert enc["port"] == enc["jax"]
    for pkg, other in (("port", "jax"), ("jax", "port")):
        mod, buf_cls = PKG[pkg]
        p = mod.parse_launch(f"appsrc name=src caps=other/{idl}-tensor ! "
                             "tensor_converter ! tensor_sink name=out")
        p.play()
        p["src"].push_buffer(buf_cls(tensors=[enc[other]]))
        back = p["out"].pull(timeout=5.0)
        p.stop()
        np.testing.assert_array_equal(np.asarray(back.tensors[0]), x)


# -- the gRPC elements across packages ---------------------------------------

CAPS_F32 = "other/tensors,format=static,dimensions=4,types=float32"


@pytest.mark.parametrize("idl", ["protobuf", "flatbuf"])
@pytest.mark.parametrize("sink_pkg,src_pkg", [("port", "jax"),
                                              ("jax", "port")])
@pytest.mark.parametrize("server", ["sink", "src"])
def test_grpc_elements_across_packages(server, sink_pkg, src_pkg, idl):
    """Each package's tensor_sink_grpc into the other's tensor_src_grpc:
    the sink serving RecvFrames to a pulling source, or the source serving
    SendFrames to a pushing sink, in both IDLs."""
    frames = [np.full(4, 1.5 * i, np.float32) for i in range(3)]
    sink_line = (f"appsrc name=src caps={CAPS_F32} ! tensor_sink_grpc "
                 f"name=gs idl={idl} ")
    src_line = f"tensor_src_grpc name=gr idl={idl} "
    if server == "sink":
        got = _grpc_pair(sink_pkg, sink_line + "server=true port=0", "gs",
                         src_pkg, src_line + "server=false port={port} "
                         "! tensor_sink name=out", "a", frames)
    else:
        got = _grpc_pair(src_pkg, src_line + "server=true port=0 "
                         "! tensor_sink name=out", "gr",
                         sink_pkg, sink_line + "server=false port={port}",
                         "b", frames, eos=True)
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g.reshape(-1), f)
