"""The converter's paths, the converter and decoder subplugins, the sensor
sources and tensor_debug through both packages, on the CPU.

Every case runs the same inputs through ``nnstreamer_tpu`` and
``nnstreamer_tpu_torch`` and holds the outputs byte-equal (same dtype,
shape and bytes; these paths copy and reinterpret bytes, they compute
nothing in floating point but the IIO scale/offset, which both packages
compute with the same numpy expression):

  - tensor_converter: the reference's converter cases
    (tests/test_elements.py:26-84: video, caps, frames-per-tensor, octet,
    flexible) and the text and audio paths, the flexbuf subplugin chosen
    by media type and the python3 subplugin chosen by ``subplugin=``;
  - converters/flexbuf.py and converters/python3.py as in
    tests/test_converters_iio.py;
  - tensor_src_iio on a fake sysfs tree in poll and buffered mode
    (tests/test_converters_iio.py: trigger attach, buffer arming, packed
    scan decode, channel selection, the padded tail, the restore on stop)
    and tensor_debug;
  - the tensor_region, octet_stream, flexbuf, direct_video and python3
    decoders (tests/test_decoders.py's cases, and a direct_video line);
  - tensor_src_tizensensor and amcsrc with and without their provider
    hooks (tests/test_platform_gated.py);
  - the port's flexible and sparse encodings against the committed
    goldens tests/golden/flexible.bin and sparse.bin, and the tensor that
    tests/golden/frame.flex.bin carries through the port's flexbuf
    decoder and converter.
"""

import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
PKGS = ("nnstreamer_tpu", "nnstreamer_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def both(fn):
    """fn(pkg) for the JAX package, then for the port."""
    return [fn(pkg) for pkg in PKGS]


def as_bytes(t):
    """A tensor or payload as (dtype, shape, bytes)."""
    if isinstance(t, (bytes, bytearray, memoryview)):
        return ("bytes", (len(bytes(t)),), bytes(t))
    a = np.ascontiguousarray(np.asarray(t))
    return (str(a.dtype), a.shape, a.tobytes())


def run_frames(pkg, line, frames, src="src", out="out", timeout=10):
    """Push ``frames`` into ``src``, EOS, collect ``out``: (outputs as
    bytes per buffer, the sink's caps, the bus error)."""
    p = mod(pkg, "pipeline").parse_launch(line)
    p.play()
    for f in frames:
        p[src].push_buffer(f)
    p[src].end_of_stream()
    p.bus.wait_eos(timeout)
    err = p.bus.error
    out_bufs = [[as_bytes(t) for t in b.tensors] for b in p[out].collected]
    caps = str(p[out].sink_pad.caps)
    p.stop()
    return out_bufs, caps, err


def run_source(pkg, line, out="out", timeout=30):
    p = mod(pkg, "pipeline").parse_launch(line)
    p.run(timeout=timeout)
    outs = [[as_bytes(t) for t in b.tensors] for b in p[out].collected]
    return outs, str(p[out].sink_pad.caps)


# -- tensor_converter -----------------------------------------------------

def _flex_blob(pkg, a):
    t = mod(pkg, "types")
    return mod(pkg, "meta").wrap_flexible(
        a, t.TensorInfo.from_np_shape(a.shape, a.dtype))


CONVERTER_LINES = {
    "video_rgb": (
        "appsrc name=src caps=video/x-raw,format=RGB,width=8,height=4,"
        "framerate=30/1 ! tensor_converter ! tensor_sink name=out",
        lambda pkg: [np.arange(8 * 4 * 3, dtype=np.uint8).reshape(4, 8, 3)]),
    "video_gray_fpt": (
        "appsrc name=src caps=video/x-raw,format=GRAY8,width=4,height=2,"
        "framerate=30/1 ! tensor_converter frames-per-tensor=2 ! "
        "tensor_sink name=out",
        lambda pkg: [np.full(8, i, np.uint8) for i in range(4)]),
    "octet": (
        "appsrc name=src caps=application/octet-stream ! tensor_converter "
        "input-dim=3:2 input-type=float32 ! tensor_sink name=out",
        lambda pkg: [np.arange(6, dtype=np.float32).tobytes()]),
    "flexible_to_static": (
        "appsrc name=src caps=other/tensors,format=flexible ! "
        "tensor_converter ! tensor_sink name=out",
        lambda pkg: [_flex_blob(pkg, np.ones((2, 3), np.float32))]),
    "text": (
        "appsrc name=src caps=text/x-raw,format=utf8 ! tensor_converter "
        "input-dim=16 ! tensor_sink name=out",
        lambda pkg: [np.frombuffer(b"hello tensors", np.uint8),
                     np.frombuffer(b"a text longer than sixteen bytes",
                                   np.uint8)]),
    "audio_s16": (
        "appsrc name=src caps=audio/x-raw,format=S16LE,channels=2,"
        "rate=16000 ! tensor_converter ! tensor_sink name=out",
        lambda pkg: [np.arange(16, dtype=np.int16).view(np.uint8)]),
    "audio_f32_fpt": (
        "appsrc name=src caps=audio/x-raw,format=F32LE,channels=1,"
        "rate=16000 ! tensor_converter frames-per-tensor=3 ! "
        "tensor_sink name=out",
        lambda pkg: [np.full((1, 1), i, np.float32) for i in range(6)]),
    "flexbuf_by_media_type": (
        "appsrc name=src caps=other/flexbuf ! tensor_converter ! "
        "tensor_sink name=out",
        lambda pkg: [_flex_blob(pkg, np.arange(6, dtype=np.int32))
                     + _flex_blob(pkg, np.ones((2, 2), np.float32))]),
}


@pytest.mark.parametrize("case", sorted(CONVERTER_LINES))
def test_converter_line(case):
    line, frames = CONVERTER_LINES[case]
    (want, jcaps, jerr), (got, pcaps, perr) = both(
        lambda pkg: run_frames(pkg, line, frames(pkg)))
    assert jerr is None and perr is None
    assert got and got == want
    assert pcaps == jcaps


@pytest.mark.parametrize("case", ["video_caps_config", "frames_per_tensor"])
def test_converter_videotestsrc(case):
    line = {"video_caps_config": "videotestsrc num-buffers=2 width=8 "
            "height=4 ! tensor_converter ! tensor_sink name=out",
            "frames_per_tensor": "videotestsrc num-buffers=4 width=4 "
            "height=2 fps=30 ! tensor_converter frames-per-tensor=2 ! "
            "tensor_sink name=out"}[case]
    (want, jcaps), (got, pcaps) = both(lambda pkg: run_source(pkg, line))
    assert got == want and pcaps == jcaps
    if case == "video_caps_config":
        assert "dimensions=3:8:4" in pcaps and "types=uint8" in pcaps
    else:
        assert len(got) == 2 and got[0][0][1] == (2, 2, 4, 3)


def test_converter_refuses_unknown_media_type():
    def go(pkg):
        _, _, err = run_frames(pkg, "appsrc name=src caps=application/x-nope "
                               "! tensor_converter ! tensor_sink name=out",
                               [b"x"])
        return err

    want, got = both(go)
    assert want is not None and got is not None
    assert "no converter for media type" in str(got.data)


# -- converter subplugins -------------------------------------------------

def _buffer(pkg, tensors):
    return mod(pkg, "buffer").Buffer(tensors=tensors)


def test_flexbuf_converter_roundtrip():
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)

    def go(pkg):
        conv = mod(pkg, "converters.flexbuf").FlexBufConverter()
        out = conv.convert(_buffer(pkg, [_flex_blob(pkg, arr)]))
        return [as_bytes(t) for t in out.tensors]

    want, got = both(go)
    assert got == want
    np.testing.assert_array_equal(
        np.frombuffer(got[0][2], np.float32).reshape(3, 4), arr)


def test_flexbuf_converter_multiple_records():
    a, b = np.ones(4, np.float32), np.arange(6, dtype=np.int32)

    def go(pkg):
        blob = _flex_blob(pkg, a) + _flex_blob(pkg, b)
        out = mod(pkg, "converters.flexbuf").FlexBufConverter().convert(
            _buffer(pkg, [blob]))
        return [as_bytes(t) for t in out.tensors]

    want, got = both(go)
    assert len(got) == 2 and got == want


@pytest.mark.parametrize("keep", [64, 96 + 8])
def test_flexbuf_converter_truncated_blob_errors(keep):
    """Cut inside the 96-byte header, or inside the payload: the same
    ValueError in both packages."""
    arr = np.ones(8, np.float32)
    msgs = []
    for pkg in PKGS:
        blob = _flex_blob(pkg, arr)
        with pytest.raises(ValueError) as e:
            mod(pkg, "converters.flexbuf").FlexBufConverter().convert(
                _buffer(pkg, [blob[:keep]]))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


CONVERTER_SCRIPT = (
    "import numpy as np\n"
    "class CustomConverter:\n"
    "    def get_out_info(self, caps_str):\n"
    "        return ('4', 'float32')\n"
    "    def convert(self, raw):\n"
    "        return [np.frombuffer(bytes(raw[0]), dtype=np.float32) * 2]\n")


def test_python3_converter_script(tmp_path):
    script = tmp_path / "conv.py"
    script.write_text(CONVERTER_SCRIPT)

    def go(pkg):
        c = mod(pkg, "converters.python3").Python3Converter(script=str(script))
        cfg = c.get_out_config(mod(pkg, "caps").Caps.from_string(
            "application/x-custom"))
        out = c.convert(_buffer(pkg, [np.ones(4, np.float32).tobytes()]))
        return cfg.info.tensors[0].dims, [as_bytes(t) for t in out.tensors]

    want, got = both(go)
    assert got == want and got[0][0] == 4


def test_python3_converter_in_a_line(tmp_path):
    """subplugin=python3 script=<file> overrides the media type."""
    script = tmp_path / "conv.py"
    script.write_text(CONVERTER_SCRIPT)
    line = ("appsrc name=src caps=application/octet-stream ! "
            f"tensor_converter subplugin=python3 script={script} ! "
            "tensor_sink name=out")
    frames = [np.arange(4, dtype=np.float32).tobytes()]
    (want, jcaps, jerr), (got, pcaps, perr) = both(
        lambda pkg: run_frames(pkg, line, frames))
    assert jerr is None and perr is None
    assert got == want and pcaps == jcaps
    assert np.frombuffer(got[0][0][2], np.float32).tolist() == [0, 2, 4, 6]


# -- tensor_src_iio and tensor_debug ---------------------------------------

def _poll_tree(tmp_path, name="accel_sim"):
    return importlib.import_module("test_converters_iio").fake_iio(
        tmp_path, name=name)


def _buffered_tree(tmp_path, n_scans):
    return importlib.import_module(
        "test_converters_iio").fake_iio_buffered(tmp_path, n_scans=n_scans)


@pytest.mark.parametrize("device", ["", "device=gyro "])
def test_iio_poll_reads_fake_sysfs(tmp_path, device):
    def go(pkg):
        base = _poll_tree(tmp_path / pkg, name="gyro" if device else
                          "accel_sim")
        return run_source(pkg, f"tensor_src_iio base-dir={base} {device}"
                          "num-buffers=3 frequency=0 ! tensor_sink name=out")

    (want, jcaps), (got, pcaps) = both(go)
    assert got == want and pcaps == jcaps and len(got) == 3
    np.testing.assert_array_equal(np.frombuffer(got[0][0][2], np.float32),
                                  [100.0, 200.0, 300.0])


def test_iio_missing_device_errors(tmp_path):
    for pkg in PKGS:
        base = _poll_tree(tmp_path / pkg)
        p = mod(pkg, "pipeline").parse_launch(
            f"tensor_src_iio base-dir={base} device=nope num-buffers=1 ! "
            "tensor_sink name=out")
        with pytest.raises(Exception, match="not found"):
            p.play()
        p.stop()


def _buffered(pkg, tmp_path, n_scans, props, prepare=None):
    """One buffered capture on a fresh fake tree: outputs, caps, and the
    sysfs files the element armed while playing and restored on stop."""
    base, devdir, expect = _buffered_tree(tmp_path / pkg, n_scans)
    dev = base / "iio:device0"
    if prepare is not None:
        prepare(dev, devdir)
    p = mod(pkg, "pipeline").parse_launch(
        f"tensor_src_iio base-dir={base} dev-dir={devdir} {props} "
        "! tensor_sink name=out")
    p.play()
    files = ("trigger/current_trigger", "buffer/length", "buffer/enable",
             "scan_elements/in_accel_x_en", "scan_elements/in_accel_y_en")
    armed = {f: (dev / f).read_text() for f in files}
    p.bus.wait_eos(10)
    outs = [[as_bytes(t) for t in b.tensors] for b in p["out"].collected]
    caps = str(p["out"].sink_pad.caps)
    p.stop()
    restored = {f: (dev / f).read_text().strip() for f in files}
    return outs, caps, armed, restored, expect


def _two_channel_scans(dev, devdir):
    scans = bytearray()
    for i in range(4):
        raw_x, raw_t = 50 * i - 60, 777 + i
        b = bytearray(16)
        b[0:2] = int(((raw_x & 0xFFF) << 4)).to_bytes(2, "little")
        b[8:16] = raw_t.to_bytes(8, "little", signed=True)
        scans += b
    (devdir / "iio:device0").write_bytes(bytes(scans))


def _y_only(dev, devdir):
    (dev / "scan_elements" / "in_accel_y_en").write_text("1\n")
    (devdir / "iio:device0").write_bytes(bytes([7, 9]))


IIO_BUFFERED = {
    "trigger_and_decode": (6, "trigger-number=3 channels=all "
                           "buffer-capacity=3 num-buffers=2", None),
    "channel_selection_unmerged": (4, "channels=0,2 buffer-capacity=4 "
                                   "num-buffers=1 merge-channels-data=false",
                                   _two_channel_scans),
    "partial_tail_padded": (5, "channels=all buffer-capacity=3 "
                            "num-buffers=2", None),
    "auto_keeps_preenabled": (2, "buffer-capacity=2 num-buffers=1", _y_only),
}


@pytest.mark.parametrize("case", sorted(IIO_BUFFERED))
def test_iio_buffered(tmp_path, case):
    n_scans, props, prepare = IIO_BUFFERED[case]
    (want, jcaps, jarm, jrest, expect), (got, pcaps, parm, prest, _) = both(
        lambda pkg: _buffered(pkg, tmp_path, n_scans, props, prepare))
    assert got and got == want and pcaps == jcaps
    assert parm == jarm and prest == jrest
    if case == "trigger_and_decode":
        assert parm["trigger/current_trigger"] == "sysfstrig3"
        assert parm["buffer/enable"] == "1"
        assert prest["buffer/enable"] == "0"
        merged = np.concatenate([np.frombuffer(b[0][2], np.float32)
                                 for b in got]).reshape(6, 3)
        np.testing.assert_allclose(merged, np.asarray(expect, np.float32),
                                   rtol=1e-6)


def test_iio_bad_type_spec_is_clear(tmp_path):
    for pkg in PKGS:
        base, devdir, _ = _buffered_tree(tmp_path / pkg, 5)
        (base / "iio:device0" / "scan_elements" / "in_accel_x_type"
         ).write_text("xx:q12/16>>4\n")
        p = mod(pkg, "pipeline").parse_launch(
            f"tensor_src_iio base-dir={base} dev-dir={devdir} channels=all "
            "num-buffers=1 ! tensor_sink name=out")
        with pytest.raises(Exception, match="type spec"):
            p.play()
        p.stop()


def test_tensor_debug_passthrough(capsys):
    line = ("videotestsrc num-buffers=2 width=8 height=8 ! tensor_converter "
            "! tensor_debug name=dbg output-mode=console capability=all ! "
            "tensor_sink name=out")
    printed = []

    def go(pkg):
        outs = run_source(pkg, line)
        printed.append(capsys.readouterr().out)
        return outs

    (want, jcaps), (got, pcaps) = both(go)
    assert got == want and pcaps == jcaps and len(got) == 2
    assert printed[1] == printed[0] and "uint8" in printed[1]


# -- decoders ---------------------------------------------------------------

def _decode(pkg, module, cls, options, tensors, infos, rate=(30, 1)):
    t = mod(pkg, "types")
    dec = getattr(mod(pkg, f"decoders.{module}"), cls)()
    dec.init(list(options) + [None] * (9 - len(options)))
    cfg = t.TensorsConfig(info=t.TensorsInfo(tensors=[
        t.TensorInfo(dims=d, dtype=dt) for d, dt in infos]),
        rate_n=rate[0], rate_d=rate[1])
    caps = str(dec.get_out_caps(cfg))
    out = dec.decode(mod(pkg, "buffer").Buffer(tensors=list(tensors)), cfg)
    return caps, [as_bytes(x) for x in out.tensors]


def test_tensor_region_crop_regions(tmp_path):
    n = 50
    priors = tmp_path / "priors.txt"
    priors.write_text("\n".join([" ".join(v for _ in range(n))
                                 for v in ("0.5", "0.5", "0.4", "0.4")]))
    boxes = np.zeros((n, 1, 4), np.float32)
    scores = np.full((n, 3), -10.0, np.float32)
    scores[7, 1] = 5.0
    (jcaps, want), (pcaps, got) = both(lambda pkg: _decode(
        pkg, "tensor_region", "TensorRegion",
        ["2", None, f"{priors}:0.5", "100:100"], [boxes, scores],
        [((4, 1, n), "float32"), ((3, n), "float32")]))
    assert got == want and pcaps == jcaps and "format=flexible" in pcaps
    arr, info = mod("nnstreamer_tpu_torch", "meta").unwrap_flexible(
        got[0][2])
    assert info.dims == (4, 2)
    assert arr.reshape(2, 4).tolist() == [[30, 30, 40, 40], [0, 0, 0, 0]]


def test_octet_stream_concat():
    a, b = np.arange(4, dtype=np.uint8), np.arange(2, dtype=np.uint8)
    (jcaps, want), (pcaps, got) = both(lambda pkg: _decode(
        pkg, "octet_stream", "OctetStream", [], [a, b],
        [((4,), "uint8"), ((2,), "uint8")]))
    assert got == want and pcaps == jcaps
    assert got[0][2] == a.tobytes() + b.tobytes()


def test_flexbuf_decoder_roundtrip():
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    (jcaps, want), (pcaps, got) = both(lambda pkg: _decode(
        pkg, "flexbuf", "FlexBuf", [], [arr], [((3, 2), "float32")]))
    assert got == want and pcaps == jcaps
    back, info = mod("nnstreamer_tpu_torch", "meta").unwrap_flexible(
        got[0][2])
    assert info.dims == (3, 2)
    np.testing.assert_array_equal(back.reshape(2, 3), arr)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_direct_video(channels):
    frame = np.arange(5 * 6 * channels, dtype=np.uint8).reshape(
        5, 6, channels)
    (jcaps, want), (pcaps, got) = both(lambda pkg: _decode(
        pkg, "direct_video", "DirectVideo", [], [frame],
        [((channels, 6, 5), "uint8")]))
    assert got == want and pcaps == jcaps
    assert got[0][1] == (5, 6, channels)


def test_direct_video_line():
    """tensor_converter ! tensor_decoder mode=direct_video: the frame back
    as video, caps included."""
    line = ("appsrc name=src caps=video/x-raw,format=RGB,width=6,height=5,"
            "framerate=30/1 ! tensor_converter ! tensor_decoder "
            "mode=direct_video ! tensor_sink name=out")
    frames = [np.arange(90, dtype=np.uint8).reshape(5, 6, 3)]
    (want, jcaps, jerr), (got, pcaps, perr) = both(
        lambda pkg: run_frames(pkg, line, frames))
    assert jerr is None and perr is None
    assert got == want and pcaps == jcaps and "video/x-raw" in pcaps
    assert got[0][0][2] == frames[0].tobytes()


def test_python3_decoder_script(tmp_path):
    script = tmp_path / "dec.py"
    script.write_text(
        "class CustomDecoder:\n"
        "    def get_out_caps(self, config):\n"
        "        return 'application/octet-stream'\n"
        "    def decode(self, raw, in_info, rate_n, rate_d):\n"
        "        return raw[0].tobytes()\n")
    (jcaps, want), (pcaps, got) = both(lambda pkg: _decode(
        pkg, "python3", "Python3Decoder", [str(script)],
        [np.arange(4, dtype=np.uint8)], [((4,), "uint8")]))
    assert got == want and pcaps == jcaps
    assert got[0][2] == bytes([0, 1, 2, 3])


def test_decoders_in_the_registry():
    """The port resolves every decoder and converter it ported under the
    JAX package's names."""
    reg = mod("nnstreamer_tpu_torch", "registry")
    for name in ("direct_video", "octet_stream", "tensor_region", "flexbuf",
                 "python3"):
        assert reg.get(reg.DECODER, name) is not None, name
    for name in ("flexbuf", "python3"):
        assert reg.get(reg.CONVERTER, name) is not None, name


# -- platform-gated sources ----------------------------------------------------

@pytest.mark.parametrize("line,match", [
    ("tensor_src_tizensensor type=accelerometer num-buffers=2 ! "
     "tensor_sink name=out", "Tizen sensor framework"),
    ("amcsrc num-buffers=1 ! tensor_sink name=out", "MediaCodec"),
])
def test_platform_source_without_provider_errors(line, match):
    for pkg in PKGS:
        p = mod(pkg, "pipeline").parse_launch(line)
        with pytest.raises(Exception, match=match):
            p.play()
        p.stop()


def test_tizensensor_with_provider():
    def go(pkg):
        ps = mod(pkg, "elements.platform_sources")
        readings = iter([[1.0, 2.0, 3.0]] * 5)
        ps.register_sensor_provider("accelerometer",
                                    lambda: next(readings, None))
        try:
            return run_source(pkg, "tensor_src_tizensensor "
                              "type=accelerometer freq=100 num-buffers=3 ! "
                              "tensor_sink name=out")
        finally:
            ps.unregister_sensor_provider("accelerometer")

    (want, jcaps), (got, pcaps) = both(go)
    assert got == want and pcaps == jcaps and len(got) == 3
    assert got[0][0][0] == "float32"


def test_amcsrc_with_provider():
    def go(pkg):
        ps = mod(pkg, "elements.platform_sources")
        frames = iter([(np.full((8, 8, 3), i, np.uint8), i * 33_000_000)
                       for i in range(4)])
        ps.register_media_provider("default", lambda: next(frames, None))
        try:
            return run_source(pkg, "amcsrc num-buffers=3 ! tensor_converter "
                              "! tensor_sink name=out")
        finally:
            ps.unregister_media_provider("default")

    (want, jcaps), (got, pcaps) = both(go)
    assert got == want and pcaps == jcaps and len(got) == 3
    assert got[1][0][1][-3:] == (8, 8, 3)


# -- goldens --------------------------------------------------------------------

def _golden(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def test_flexible_golden():
    """The port's flexbuf decoder on the golden input writes
    tests/golden/flexible.bin byte for byte, and its flexbuf converter
    reads it back to the input."""
    arr = np.load(os.path.join(GOLDEN, "wire_input.npy"))
    _, got = _decode("nnstreamer_tpu_torch", "flexbuf", "FlexBuf", [], [arr],
                     [((4, 3), "int16")])
    assert got[0][2] == _golden("flexible.bin")
    out = mod("nnstreamer_tpu_torch", "converters.flexbuf").FlexBufConverter(
    ).convert(_buffer("nnstreamer_tpu_torch", [_golden("flexible.bin")]))
    assert as_bytes(out.tensors[0]) == as_bytes(arr)


def test_sparse_golden():
    """tensor_sparse_enc in the port writes tests/golden/sparse.bin byte
    for byte, and tensor_sparse_dec reads it back."""
    x = np.zeros(16, np.float32)
    x[[2, 7, 11]] = [1.5, -2.0, 3.25]
    got, _, err = run_frames(
        "nnstreamer_tpu_torch",
        "appsrc name=src caps=other/tensors,format=static,dimensions=16,"
        "types=float32 ! tensor_sparse_enc ! tensor_sink name=out", [x])
    assert err is None and got[0][0][2] == _golden("sparse.bin")
    back, _, err = run_frames(
        "nnstreamer_tpu_torch",
        "appsrc name=src caps=other/tensors,format=sparse ! "
        "tensor_sparse_dec ! tensor_sink name=out", [_golden("sparse.bin")])
    assert err is None and back[0][0] == as_bytes(x)


def test_flexbuffers_frame_golden_tensor():
    """tests/golden/frame.flex.bin is a flexbuffers frame (the flatbuf
    path, not ported: it needs the flatbuffers package). The tensor it
    carries, read with the JAX package's reader, goes through the port's
    flexbuf decoder to flexible.bin's bytes and back through its
    converter unchanged."""
    from nnstreamer_tpu.rpc.flat import frame_from_flex

    frame, cfg = frame_from_flex(_golden("frame.flex.bin"))
    arr = np.asarray(frame.tensors[0])
    assert frame.pts == 42 and cfg.info[0].dims == (4, 3)
    _, got = _decode("nnstreamer_tpu_torch", "flexbuf", "FlexBuf", [], [arr],
                     [(cfg.info[0].dims, cfg.info[0].dtype.value)])
    assert got[0][2] == _golden("flexible.bin")
    out = mod("nnstreamer_tpu_torch", "converters.flexbuf").FlexBufConverter(
    ).convert(_buffer("nnstreamer_tpu_torch", [got[0][2]]))
    assert as_bytes(out.tensors[0]) == as_bytes(arr)
