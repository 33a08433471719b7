"""The port's attention models (ViT, StreamTransformer) against the JAX
package's flax models, and their launch lines through both packages.

float32: flax built with ``dtype=jnp.float32`` and the port on the same
weights (carried across by ``from_jax_variables``), at atol/rtol 1e-4 (ViT,
with 5e-4 on its logits) — only the order of float32 sums differs.
bfloat16: the zoo builders of both packages on flax's ``seed:0`` weights,
at the JAX package's bf16 tolerance for logits (atol 0.15, rtol 0.05;
tests/test_fused_block.py::test_model_zoo_fused_custom) — the two
frameworks round bf16 matmuls, GELU and LayerNorm outputs at the same
points but compute each in their own order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu import pipeline as jax_pipeline  # noqa: E402
from nnstreamer_tpu.buffer import Buffer as JaxBuffer  # noqa: E402
from nnstreamer_tpu_torch import pipeline as port_pipeline  # noqa: E402
from nnstreamer_tpu_torch.buffer import Buffer as PortBuffer  # noqa: E402
from nnstreamer_tpu_torch.models.convert import (  # noqa: E402
    from_jax_variables,
    save_state_dict,
)
from nnstreamer_tpu_torch.models.vit import (  # noqa: E402
    ViT,
    StreamTransformer,
)
from nnstreamer_tpu_torch.ops import attention as port_attn  # noqa: E402

VIT = dict(size=32, patch=8, dim=64, depth=2, heads=2, classes=16)
STREAM = dict(seq=128, feat=16, dim=256, depth=1, heads=2)  # head_dim 128
VIT_CUSTOM = ",".join(f"{k}:{v}" for k, v in VIT.items())
STREAM_CUSTOM = ",".join(f"{k}:{v}" for k, v in STREAM.items())


def _flax_f32(kind, causal=True):
    from nnstreamer_tpu.models import vit as jax_vit

    rng = np.random.default_rng(3)
    if kind == "vit":
        model = jax_vit.ViT(dtype=jnp.float32, **VIT)
        x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    else:
        model = jax_vit.StreamTransformer(dtype=jnp.float32, causal=causal,
                                          **STREAM)
        x = rng.normal(size=(2, 128, 16)).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(1), jnp.asarray(x))
    # flax inits cls to 0 and LayerNorm to the identity: perturb every leaf
    # so each weight the conversion carries is checked
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(
            np.float32), jax.device_get(variables))
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    return variables, x, want


def _port_f32(kind, variables, causal=True, **kw):
    if kind == "vit":
        m = ViT(dtype=torch.float32, **VIT, **kw)
    else:
        m = StreamTransformer(dtype=torch.float32, causal=causal, **STREAM,
                              **kw)
    m.load_state_dict(from_jax_variables(variables))
    return m.eval()


@pytest.mark.parametrize("attention", ["auto", "plain"])
def test_vit_f32_matches_flax(attention):
    """'auto' routes as the JAX package does on the CPU; 'plain' is the
    kernel's plain version, the oracle instance chip_smoke.py builds."""
    variables, x, want = _flax_f32("vit")
    kw = ({} if attention == "auto"
          else {"attention": port_attn.flash_attention_plain})
    with torch.no_grad():
        got = _port_f32("vit", variables, **kw)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("causal", [True, False])
def test_stream_transformer_f32_matches_flax(causal):
    variables, x, want = _flax_f32("stream", causal)
    with torch.no_grad():
        got = _port_f32("stream", variables, causal)(
            torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 128, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_convert_vit_tree_without_batch_stats():
    """A transformer tree has no batch_stats, and ViT has a top-level
    Dense_0 like MobileNet-v2: the conversion dispatches on _Block_0."""
    variables, _, _ = _flax_f32("vit")
    assert "batch_stats" not in variables and "Dense_0" in variables["params"]
    state = from_jax_variables(variables)
    assert set(state) == set(ViT(**VIT).state_dict())
    np.testing.assert_array_equal(
        state["head.weight"].numpy(),
        np.asarray(variables["params"]["Dense_0"]["kernel"]).T)


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """flax seed:0 weights of both models from the JAX zoo, as the JAX
    bundles and as npz files for the port."""
    from nnstreamer_tpu.models import get_model

    d = tmp_path_factory.mktemp("attn_zoo")
    out = {}
    for name, custom in (("vit", VIT_CUSTOM), ("stream_transformer",
                                                STREAM_CUSTOM)):
        b = get_model(name, dict(kv.split(":") for kv in
                                 f"seed:0,{custom}".split(",")))
        path = str(d / f"{name}.npz")
        save_state_dict(from_jax_variables(jax.device_get(b.params)), path)
        out[name] = (b, path)
    return out


def _port_bundle(name, path, custom):
    from nnstreamer_tpu_torch.models import get_model

    return get_model(name, dict(kv.split(":") for kv in
                                f"params:{path},{custom}".split(",")),
                     device="cpu")


def test_vit_bf16_builder_matches_jax_zoo(zoo):
    b, path = zoo["vit"]
    x = np.random.default_rng(4).integers(0, 256, (4, 32, 32, 3), np.uint8)
    want = np.asarray(b.apply_fn(b.params, jnp.asarray(x)))
    got = _port_bundle("vit", path, VIT_CUSTOM).apply_fn(
        torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (4, 16)
    np.testing.assert_allclose(got, want, atol=0.15, rtol=0.05)


def test_stream_bf16_builder_matches_jax_zoo(zoo):
    """A 2-D (seq, feat) window gains the batch dim, as in the JAX
    apply_fn."""
    b, path = zoo["stream_transformer"]
    x = np.random.default_rng(5).normal(size=(128, 16)).astype(np.float32)
    want = np.asarray(b.apply_fn(b.params, jnp.asarray(x)))
    got = _port_bundle("stream_transformer", path, STREAM_CUSTOM).apply_fn(
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 128, 16)
    np.testing.assert_allclose(got, want, atol=0.15, rtol=0.05)


def test_stream_transformer_is_causal():
    """The JAX package's check (tests/test_models.py): changing the tail
    must not change earlier outputs."""
    from nnstreamer_tpu_torch.models import get_model

    b = get_model("stream_transformer",
                  {"seq": "128", "feat": "16", "dim": "32", "depth": "1",
                   "heads": "2", "seed": "0"}, device="cpu")
    x = torch.ones(2, 128, 16)
    y = b.apply_fn(x)
    assert tuple(y.shape) == (2, 128, 16)
    x2 = x.clone()
    x2[:, 100:, :] = 5.0
    y2 = b.apply_fn(x2)
    np.testing.assert_allclose(y[:, :100].numpy(), y2[:, :100].numpy(),
                               atol=1e-4)
    assert not torch.allclose(y[:, 100:], y2[:, 100:])


@pytest.mark.parametrize("name", ["vit", "stream_transformer"])
def test_params_npz_round_trip(zoo, name):
    """custom=params:<npz> loads exactly what save_state_dict wrote."""
    b, path = zoo[name]
    custom = VIT_CUSTOM if name == "vit" else STREAM_CUSTOM
    got = _port_bundle(name, path, custom).module.state_dict()
    want = from_jax_variables(jax.device_get(b.params))
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("name", ["vit", "stream_transformer"])
def test_seed_init_is_deterministic(name):
    from nnstreamer_tpu_torch.models import get_model

    cfg = {"vit": {"size": "32", "patch": "8", "dim": "32", "depth": "1",
                   "heads": "2", "classes": "8"},
           "stream_transformer": {"seq": "16", "feat": "8", "dim": "32",
                                  "depth": "1", "heads": "2"}}[name]
    a = get_model(name, dict(cfg, seed="3"), device="cpu").module.state_dict()
    b = get_model(name, dict(cfg, seed="3"), device="cpu").module.state_dict()
    c = get_model(name, dict(cfg, seed="4"), device="cpu").module.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pos"], c["pos"])
    assert not torch.allclose(a["norm.weight"], torch.ones_like(
        a["norm.weight"]))


def test_zoo_caps_and_output_info():
    from nnstreamer_tpu_torch.models import get_model
    from nnstreamer_tpu_torch.types import TensorsInfo

    v = get_model("vit", {"size": "32", "patch": "8", "dim": "32",
                          "depth": "1", "heads": "2", "classes": "8"},
                  device="cpu")
    assert v.input_info.dimensions_string() == "3:32:32"
    assert v.output_info.dimensions_string() == "8"
    out = v.infer_output(TensorsInfo.from_strings("3:32:32:4", "uint8"))
    assert out.tensors[0].np_shape() == (4, 8)
    s = get_model("stream_transformer", {"seq": "16", "feat": "8",
                                         "dim": "32", "depth": "1",
                                         "heads": "2"}, device="cpu")
    assert s.input_info.dimensions_string() == "8:16"
    assert s.input_info.types_string() == "float32"
    out = s.infer_output(TensorsInfo.from_strings("8:16", "float32"))
    assert out == TensorsInfo.from_strings("8:16:1", "float32")


# -- the launch lines through both packages --------------------------------

def _run(mod, buffer_cls, line, chunks):
    p = mod.parse_launch(line)
    p.play()
    for c in chunks:
        p["src"].push_buffer(buffer_cls(tensors=[c]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(120)
    assert p.bus.error is None, p.bus.error
    out = list(p["out"].collected)
    p.stop()
    return out


def test_stream_line_matches(zoo):
    """The long-context line at a small size: 32-frame chunks windowed to
    128 frames by tensor_aggregator, then the stream transformer."""
    _, path = zoo["stream_transformer"]
    line = ("appsrc name=src caps=other/tensors,format=static,"
            "dimensions=16:32,types=float32 ! tensor_aggregator frames_in=32 "
            "frames_out=128 frames_dim=1 ! tensor_filter framework=jax "
            "model=stream_transformer custom={custom} {extra}! tensor_sink "
            "name=out")
    rng = np.random.default_rng(6)
    chunks = [rng.normal(size=(32, 16)).astype(np.float32) for _ in range(8)]
    want = _run(jax_pipeline, JaxBuffer,
                line.format(custom=f"seed:0,{STREAM_CUSTOM}", extra=""),
                chunks)
    got = _run(port_pipeline, PortBuffer,
               line.format(custom=f"params:{path},{STREAM_CUSTOM}",
                           extra="accelerator=true:cpu "), chunks)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        g, w = np.asarray(g.tensors[0]), np.asarray(w.tensors[0])
        assert g.shape == w.shape == (1, 128, 16)
        np.testing.assert_allclose(g, w, atol=0.15, rtol=0.05)


def test_vit_labeling_line_matches(zoo, tmp_path):
    """ViT in the image-labeling line, 4 frames per tensor, fetch-window=2:
    logits within the bf16 tolerance and equal labels per frame."""
    _, path = zoo["vit"]
    labels = str(tmp_path / "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"label{i}" for i in range(16)) + "\n")

    def line(custom, extra="", tail=""):
        return ("appsrc name=src caps=video/x-raw,format=RGB,width=32,"
                "height=32,framerate=30/1 ! tensor_converter "
                f"frames-per-tensor=4 ! tensor_filter framework=jax model=vit "
                f"custom={custom} fetch-window=2 {extra}! queue {tail}"
                "! tensor_sink name=out")

    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, (32, 32, 3), np.uint8) for _ in range(8)]
    port_extra = "accelerator=true:cpu "
    want = _run(jax_pipeline, JaxBuffer, line(f"seed:0,{VIT_CUSTOM}"), frames)
    got = _run(port_pipeline, PortBuffer,
               line(f"params:{path},{VIT_CUSTOM}", port_extra), frames)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.tensors[0]),
                                   np.asarray(w.tensors[0]), atol=0.15,
                                   rtol=0.05)
    tail = f"! tensor_decoder mode=image_labeling option1={labels} "
    want = _run(jax_pipeline, JaxBuffer,
                line(f"seed:0,postproc:argmax,{VIT_CUSTOM}", tail=tail),
                frames)
    got = _run(port_pipeline, PortBuffer,
               line(f"params:{path},postproc:argmax,{VIT_CUSTOM}", port_extra,
                    tail), frames)
    want_labels = [lab for b in want for lab in b.meta["label"]]
    got_labels = [lab for b in got for lab in b.meta["label"]]
    assert len(got_labels) == 8
    assert got_labels == want_labels
