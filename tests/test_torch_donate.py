"""``custom=donate:1`` through both packages, on the CPU.

The port's backend donates only the input buffers no other element can
hold (its own device copy of a host input, a prefetch handle's uploads)
and drops its last reference to them once the first stage has read them;
nothing is written in place, so the outputs are bit-equal to donation off.
Held here: the small flagship line with the preamble fused (MobileNet-v2
at 64 px, ``accelerator=true:cpu``) at feed-depth 1 and 2, donate on
against off; the backend's handling of a prefetch handle and of an
upstream tensor; the refusal of a donating filter behind a tee in both
packages; and the NNST802/803 donation lints against the JAX analyzer on
the same lines.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
pytest.importorskip("jax")

import nnstreamer_tpu.analysis  # noqa: E402
import nnstreamer_tpu.pipeline  # noqa: E402
import nnstreamer_tpu.pipeline.planner  # noqa: E402
import nnstreamer_tpu_torch.analysis  # noqa: E402
import nnstreamer_tpu_torch.buffer  # noqa: E402
import nnstreamer_tpu_torch.filters.base  # noqa: E402
import nnstreamer_tpu_torch.pipeline  # noqa: E402
import nnstreamer_tpu_torch.pipeline.planner  # noqa: E402
from nnstreamer_tpu_torch.log import ElementError  # noqa: E402

CAPS_F32 = ("other/tensors,num-tensors=1,dimensions=4:2,types=float32,"
            "framerate=0/1")
PREAMBLE = "typecast:float32,add:-127.5,div:127.5"
MBV2 = "seed:0,size:64,width:0.35,classes:16,fused:pallas"

PORT_PARSE = sys.modules["nnstreamer_tpu_torch.pipeline"].parse_launch
JAX_PARSE = sys.modules["nnstreamer_tpu.pipeline"].parse_launch
Buffer = sys.modules["nnstreamer_tpu_torch.buffer"].Buffer


def _flagship(custom, extra=""):
    return ("appsrc name=src caps=video/x-raw,format=RGB,width=64,height=64,"
            "framerate=30/1 ! tensor_converter frames-per-tensor=2 "
            f"! tensor_transform name=tr mode=arithmetic option={PREAMBLE} "
            "! tensor_filter name=f framework=torch_cuda model=mobilenet_v2 "
            f"custom={custom} accelerator=true:cpu {extra} "
            "! tensor_sink name=out")


def _run(line, n=8):
    rng = np.random.default_rng(5)
    p = PORT_PARSE(line)
    p.play()
    for i in range(n):
        p["src"].push_buffer(Buffer(
            tensors=[rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)],
            pts=i))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(120)
    assert p.bus.error is None, p.bus.error
    outs = [np.asarray(b.tensors[0]) for b in p["out"].collected]
    fw = p["f"].fw
    p.stop()
    return outs, fw


@pytest.mark.parametrize("extra", ["", "feed-depth=2"])
def test_donate_outputs_bit_equal_to_off(extra):
    off, fw_off = _run(_flagship(MBV2, extra))
    on, fw_on = _run(_flagship(MBV2 + ",donate:1", extra))
    assert not fw_off._donate and fw_on._donate
    assert len(on) == len(off) == 4
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _open_backend(custom):
    from nnstreamer_tpu_torch.filters.cuda_filter import TorchCudaFilter

    fw = TorchCudaFilter()
    fw.open(sys.modules["nnstreamer_tpu_torch.filters.base"]
            .FilterProperties(framework="torch_cuda",
                              model_files=["add"], custom=custom,
                              accelerator="true:cpu"))
    return fw


@pytest.mark.parametrize("donate", [True, False])
def test_backend_releases_only_its_own_buffers(donate):
    """A donating backend empties a donatable prefetch handle (the
    element's last references to the uploads) and leaves a handle over an
    upstream tensor, which is never donatable, as it is; without
    donation nothing is emptied. The outputs are the same either way."""
    fw = _open_backend("k:1" + (",donate:1" if donate else ""))
    host = np.arange(8, dtype=np.float32).reshape(4, 2)
    handle = fw.prefetch([host])
    assert handle.donatable
    out = fw.invoke(handle)
    assert (len(handle) == 0) == donate
    np.testing.assert_array_equal(np.asarray(out[0]), host + 1)
    upstream = torch.ones(4, 2)
    handle = fw.prefetch([upstream])
    assert not handle.donatable
    fw.invoke(handle)
    assert len(handle) == 1 and handle[0] is upstream
    fw.close()


DONATE_TEE = (f"appsrc name=src caps={CAPS_F32} ! tee name=t  "
              "t. ! queue ! tensor_filter name=f framework=jax model=add "
              "custom=k:1,donate:1{cpu} ! tensor_sink name=a  "
              "t. ! queue ! tensor_sink name=b")


@pytest.mark.parametrize("package", ["jax", "port"])
def test_donate_behind_tee_refused_at_setup(package):
    port = package == "port"
    parse = PORT_PARSE if port else JAX_PARSE
    p = parse(DONATE_TEE.format(cpu=" accelerator=true:cpu" if port
                                else ""))
    err = ElementError if port else \
        sys.modules["nnstreamer_tpu.log"].ElementError
    with pytest.raises(err, match=r"donate:1 is unsafe here.*'t'"):
        p["f"].start()


@pytest.mark.parametrize("custom", [
    "donate:1", "k:1,donate:1", "donate: 1", "donate:true", "donate:input",
    "donate:0", "k:1", "", "donate:yes"])
def test_donation_requested_parses_like_the_reference(custom):
    ours = sys.modules["nnstreamer_tpu_torch.pipeline.planner"]
    ref = sys.modules["nnstreamer_tpu.pipeline.planner"]
    assert ours.donation_requested(custom) == ref.donation_requested(custom)


#: lines where the donation lints fire or must stay silent (every filter
#: named: the two packages' element name counters differ)
LINT_LINES = [
    # NNST802: donating behind a tee (through a queue)
    DONATE_TEE.format(cpu=""),
    # donating, private, host-fed: clean
    f"appsrc caps={CAPS_F32} ! tensor_filter name=f framework=jax "
    "model=add custom=k:1,donate:1 ! tensor_sink",
    # NNST803: host-fed, private, not donating
    f"appsrc caps={CAPS_F32} ! tensor_filter name=f framework=jax "
    "model=add custom=k:1 ! tensor_sink",
    # behind a tee without donating: neither
    f"appsrc caps={CAPS_F32} ! tee name=t  t. ! queue ! tensor_filter "
    "name=f framework=jax model=add custom=k:1 ! tensor_sink  t. ! queue "
    "! tensor_sink",
    # a shared backend: no NNST803
    f"appsrc caps={CAPS_F32} ! tensor_filter name=f framework=jax "
    "model=add custom=k:1 shared-tensor-filter-key=s1 ! tensor_sink",
    # output-combination re-emits an input: no NNST803
    f"appsrc caps={CAPS_F32} ! tensor_filter name=f framework=jax "
    "model=add custom=k:1 output-combination=i0,o0 ! tensor_sink",
    # device-fed second filter: only the first is host-fed
    f"appsrc caps={CAPS_F32} ! tensor_filter name=f1 framework=jax "
    "model=add custom=k:1 ! queue ! tensor_filter name=f2 framework=jax "
    "model=add custom=k:10 chain-fusion=off ! tensor_sink",
]


#: the donation lints each line gives, by filter
LINT_WANT = [[("NNST802", "f")], [], [("NNST803", "f")], [], [], [],
             [("NNST803", "f1")]]


@pytest.mark.parametrize("line,expect", list(zip(LINT_LINES, LINT_WANT)),
                         ids=[f"line{i}" for i in range(len(LINT_LINES))])
def test_donation_lints_match_reference(line, expect):
    def lints(analyze_launch):
        return sorted((d.code, d.element) for d in analyze_launch(line)
                      if d.code in ("NNST802", "NNST803"))

    got = lints(sys.modules["nnstreamer_tpu_torch.analysis"].analyze_launch)
    want = lints(sys.modules["nnstreamer_tpu.analysis"].analyze_launch)
    assert got == want == expect
