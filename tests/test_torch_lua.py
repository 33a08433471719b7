"""framework=lua through the port (counterpart of tests/test_lua_filter.py):
every pipeline case of the reference's file through both packages, with
outputs equal to the JAX backend's and to the reference's expectations
on the same scripts and frames; the embedded interpreter's cases through
both packages' ``minilua`` (the port's is a copy: the same globals, the
same errors); and the host read a device tensor takes into the backend.

Outputs are compared bit for bit: both packages run the same interpreter
on the same numpy arrays.
"""

import importlib
import math

import numpy as np
import pytest
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)

pytest.importorskip("torch")
pytest.importorskip("jax")

import test_lua_filter as ref  # noqa: E402

PKGS = ["nnstreamer_tpu", "nnstreamer_tpu_torch"]
CAPS4 = ("appsrc name=src caps=other/tensors,num-tensors=1,"
         "dimensions=4,types=float32,framerate=0/1 ")

SCALE_SCRIPT = """
inputTensorsInfo = { num = 1, dim = {{4, 1, 1, 1},}, type = {'float32',} }
outputTensorsInfo = { num = 1, dim = {{4, 1, 1, 1},}, type = {'float32',} }
function nnstreamer_invoke()
  local inp = input_tensor(1)
  local out = output_tensor(1)
  for i = 1, 4 do
    out[i] = inp[i] * 2.0 + 0.5
  end
end
"""

LEGACY_SCRIPT = """
inputConf  = { dims = {4, 1}, type = "float32" }
outputConf = { dims = {4, 1}, type = "float32" }
function nnstreamer_invoke(input)
  local output = {}
  for i = 1, 4 do output[i] = input[i] + 1 end
  return output
end
"""


def _pkg(name, mod):
    return importlib.import_module(f"{name}.{mod}")


def _run(pkg, line, frames, model=None):
    """Push ``frames`` (lists of arrays) through ``line`` in ``pkg``;
    the sink's tensors per buffer as numpy arrays."""
    p = _pkg(pkg, "pipeline").parse_launch(line)
    if model is not None:
        p["f"].set_property("model", model)
    Buffer = _pkg(pkg, "buffer").Buffer
    p.play()
    for f in frames:
        p["src"].push_buffer(Buffer(tensors=list(f)))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(30), p.bus.error and p.bus.error.data
    out = [[np.asarray(t) for t in b.tensors] for b in p["out"].collected]
    p.stop()
    return out


def _both(line, frames, model=None):
    """The port's outputs, after checking them equal to the JAX
    package's."""
    want = _run(PKGS[0], line, frames, model)
    got = _run(PKGS[1], line, frames, model)
    assert len(got) == len(want) == len(frames)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.reshape(-1), b.reshape(-1))
    return got


# -- the reference file's pipeline cases, through both packages -------------

def test_reference_style_script():
    rng = np.random.default_rng(0)
    frames = [(rng.integers(0, 256, (8, 8, 3), np.uint8),
               rng.integers(0, 256, (4, 4, 3), np.uint8)) for _ in range(3)]
    got = _both("appsrc name=src caps=other/tensors,num-tensors=2,"
                "dimensions=3:8:8.3:4:4,types=uint8.uint8,framerate=0/1 "
                "! tensor_filter framework=lua name=f ! tensor_sink name=out",
                frames, ref.REF_STYLE_SCRIPT)
    for (a, _), out in zip(frames, got):
        np.testing.assert_array_equal(out[0].reshape(a.shape), a)
        np.testing.assert_allclose(out[1].reshape(-1), [11.0, 22.0])


@pytest.mark.parametrize("suffix", [".lua", ".script"])
def test_file_mode(tmp_path, suffix):
    """File mode by the file's existence, with or without ``.lua``."""
    script = tmp_path / f"scale{suffix}"
    script.write_text(SCALE_SCRIPT)
    x = np.arange(4, dtype=np.float32)
    got = _both(CAPS4 + f"! tensor_filter framework=lua model={script} "
                "! tensor_sink name=out", [(x,), (x + 3,)])
    np.testing.assert_allclose(got[0][0], x * 2.0 + 0.5)
    np.testing.assert_allclose(got[1][0], (x + 3) * 2.0 + 0.5)


def test_legacy_conf_convention():
    x = np.arange(4, dtype=np.float32).reshape(1, 4)
    got = _both("appsrc name=src caps=other/tensors,num-tensors=1,"
                "dimensions=4:1,types=float32,framerate=0/1 "
                "! tensor_filter framework=lua name=f ! tensor_sink name=out",
                [(x,)], LEGACY_SCRIPT)
    np.testing.assert_allclose(got[0][0].reshape(-1), np.arange(4) + 1.0)


@pytest.mark.parametrize("pkg", PKGS)
def test_missing_invoke_fn_rejected(pkg):
    p = _pkg(pkg, "pipeline").parse_launch(
        CAPS4 + "! tensor_filter framework=lua name=f ! tensor_sink name=out")
    p["f"].set_property("model", "x = 1")
    with pytest.raises(Exception, match="nnstreamer_invoke"):
        p.play()
    p.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_missing_lua_file_names_the_file(pkg):
    p = _pkg(pkg, "pipeline").parse_launch(
        CAPS4 + "! tensor_filter framework=lua model=/no/such/dir/x.lua "
        "! tensor_sink name=out")
    with pytest.raises(Exception, match="file not found"):
        p.play()
    p.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_legacy_nil_return_drops_the_buffer(pkg):
    p = _pkg(pkg, "pipeline").parse_launch(
        CAPS4 + "! tensor_filter framework=lua name=f ! tensor_sink name=out")
    p["f"].set_property("model", (
        'inputConf  = { dims = {4, 1}, type = "float32" }\n'
        'outputConf = { dims = {4, 1}, type = "float32" }\n'
        "function nnstreamer_invoke(input)\n"
        "end"))
    p.play()
    p["src"].push_buffer(_pkg(pkg, "buffer").Buffer(
        tensors=[np.zeros(4, np.float32)]))
    assert p["out"].pull(timeout=5.0) is None
    p.stop()


# -- the interpreter: both packages' minilua on the reference's scripts ------

SCRIPTS = {
    "arith": ("a = 7 // 2 b = 7 % 3 c = -7 % 3 d = 2 ^ 10 e = 7 / 2",
              {"a": 3, "b": 1, "c": 2, "d": 1024.0, "e": 3.5}),
    "tables": ("t = { 10, 20, 30, x = 'hi', [100] = 'sparse' } n = #t "
               "s = t.x .. '!' .. t[2] t[#t + 1] = 40 m = #t",
               {"n": 3, "s": "hi!20", "m": 4}),
    "control": ("""
function fib(n)
  if n < 2 then return n end
  return fib(n - 1) + fib(n - 2)
end
r = fib(10)
local acc = 0
for i = 10, 1, -2 do acc = acc + i end
down = acc
w = 0
while w < 5 do w = w + 1 end
rep = 0
repeat rep = rep + 1 until rep >= 3
bs = 0
for i = 1, 100 do
  if i > 4 then break end
  bs = bs + i
end
""", {"r": 55, "down": 30, "w": 5, "rep": 3, "bs": 10}),
    "assign": ("function two() return 1, 2 end a, b = two() c, d = 5 "
               "x, y = y or 10, 20",
               {"a": 1, "b": 2, "c": 5, "d": None, "x": 10}),
    "stdlib": ("f = math.floor(3.7) mx = math.max(1, 9, 4) "
               "s = string.format('%d-%s-%.2f', 42, 'ok', 1.5) ip = 0 "
               "for i, v in ipairs({5, 6, 7}) do ip = ip + i * v end "
               "keys = 0 for k, v in pairs({a = 1, b = 2}) do "
               "keys = keys + v end",
               {"f": 3, "mx": 9, "s": "42-ok-1.50", "ip": 38, "keys": 3}),
    "sub": ("s = 'abcdef' a = string.sub(s, 1, -2) b = string.sub(s, -3) "
            "c = string.sub(s, 2, -2) d = string.sub(s, -2, -1) "
            "e = string.sub(s, 4, 2) f = string.sub(s, 0, 3) "
            "g = string.sub(s, -100, 100)",
            {"a": "abcde", "b": "def", "c": "bcde", "d": "ef", "e": "",
             "f": "abc", "g": "abcdef"}),
    "division": ("a = 1/0 b = -1/0 d = 1.0 // 0",
                 {"a": math.inf, "b": -math.inf, "d": math.inf}),
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_minilua_matches_the_jax_package(case):
    src, want = SCRIPTS[case]
    got = {}
    for pkg in PKGS:
        rt = _pkg(pkg, "filters.minilua").MiniLua()
        rt.execute(src)
        got[pkg] = {k: rt.get_global(k) for k in want}
    assert got[PKGS[1]] == got[PKGS[0]] == want


@pytest.mark.parametrize("src,match", [
    ("s = ('x'):upper()", "method"),
    ("x = 5 x()", "call"),
    ("x = nil y = x.field", "index"),
    ("x = string.byte('', 1)", "runtime error"),
    ("x = 0x", ""),
    ("x = 1 // 0", "n//0"),
])
def test_minilua_errors_match(src, match):
    msgs = []
    for pkg in PKGS:
        mod = _pkg(pkg, "filters.minilua")
        with pytest.raises(mod.LuaError, match=match) as e:
            mod.MiniLua().execute(src)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_host_iterables_and_bindings():
    from nnstreamer_tpu_torch.filters.minilua import LuaError, LuaTable, MiniLua

    rt = MiniLua()
    rt.set_global("t", LuaTable({1: 2, 2: 4, 3: 8}))
    rt.execute("s = 0 for i, v in ipairs(t) do s = s + v end")
    assert rt.get_global("s") == 14
    rt.set_global("bad", lambda: (None).nope)
    with pytest.raises(LuaError, match="runtime error"):
        rt.execute("bad()")


# -- device tensors into the host backend ------------------------------------

def test_device_tensors_take_one_host_read():
    """A model filter's tensors (on the CPU the backend's own tensors)
    into the Lua filter: the Lua backend is not device-capable, so the
    residency planner has the model filter hand host tensors on, one
    billed ``d2h`` read a buffer on the whole line; the Lua filter's
    outputs are numpy."""
    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.pipeline import parse_launch

    line = (CAPS4 + "! tensor_filter framework=jax model=add custom=k:1 "
            "accelerator=true:cpu name=m ! tensor_filter framework=lua "
            "name=f ! tensor_sink name=out")
    frames = [np.arange(4, dtype=np.float32) + i for i in range(3)]
    p = parse_launch(line)
    p["f"].set_property("model", SCALE_SCRIPT)
    tracer = trace.attach(p)
    p.play()
    for x in frames:
        p["src"].push_buffer(Buffer(tensors=[x]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(30)
    outs = [b.tensors[0] for b in p["out"].collected]
    c = tracer.crossings()
    p.stop()
    assert (c["d2h"], c["d2h_bytes"]) == (3, 3 * 16)
    assert "f" not in c["per_element"]
    assert all(isinstance(o, np.ndarray) for o in outs)
    for o, x in zip(outs, frames):
        np.testing.assert_array_equal(o, (x + 1) * 2.0 + 0.5)
