"""The flagship slice end to end through both packages, on the CPU.

The same launch line runs through ``nnstreamer_tpu.pipeline.parse_launch``
(the JAX reference, flax weights from ``seed:0``, perturbed as
``_perturb`` says and loaded with ``params:<msgpack>``) and through the
port's ``parse_launch`` (the same weights carried across with
``from_jax_variables`` and loaded with ``params:<npz>``, on the CPU with
``accelerator=true:cpu``), and the same frames are pushed into both.
Tolerances: logits at the JAX package's bf16 tolerance
(atol 0.15, rtol 0.05; tests/test_fused_block.py::test_model_zoo_fused_custom),
labels equal on every frame.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")

from nnstreamer_tpu import pipeline as jax_pipeline  # noqa: E402
from nnstreamer_tpu.buffer import Buffer as JaxBuffer  # noqa: E402
from nnstreamer_tpu_torch import pipeline as port_pipeline  # noqa: E402
from nnstreamer_tpu_torch.buffer import Buffer as PortBuffer  # noqa: E402

CUSTOM = "size:64,width:0.35,classes:16,fused:pallas"
N_FRAMES = 8


def _line(custom, labels=None, extra=""):
    tail = (f"! tensor_decoder mode=image_labeling option1={labels} "
            if labels else "")
    return ("appsrc name=src caps=video/x-raw,format=RGB,width=64,height=64,"
            "framerate=30/1 ! tensor_converter frames-per-tensor=4 "
            f"! tensor_filter name=f framework=jax model=mobilenet_v2 "
            f"custom={custom} fetch-window=2 {extra}! queue "
            f"{tail}! tensor_sink name=out")


def _run(mod, buffer_cls, line, frames):
    p = mod.parse_launch(line)
    p.play()
    for f in frames:
        p["src"].push_buffer(buffer_cls(tensors=[f]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(120)
    assert p.bus.error is None, p.bus.error
    out = list(p["out"].collected)
    stats = p["f"].fw.compile_stats()
    p.stop()
    return out, stats


def _perturb(variables, seed):
    """Flax's init has identity BatchNorm and a Dense layer whose common
    mode sends every frame to one class with sub-1e-3 margins. Perturb the
    BN parameters/statistics and center (and scale) the Dense kernel so
    that frames get different labels: with seed 5 and the frames below,
    2 classes and a smallest top-2 margin of 5.5 on logits up to about 100
    (JAX fused forward, bf16). The scaling amplifies bf16 noise as much as
    the margins: port and JAX logits then differ by up to 5.6, the same
    size as the JAX package's own fused-vs-unfused difference on these
    weights (up to 6.5), so logits are compared on the unperturbed weights
    (test_flagship_logits_match) and only labels here. The seed was picked
    for its margins; the run is deterministic on the CPU."""
    rng = np.random.default_rng(seed)

    def pert(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "Dense" in name:
            return ((a - a.mean(0, keepdims=True)) * 30).astype(a.dtype) \
                if "kernel" in name else a
        if "var" in name:
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(a.dtype)
        if "mean" in name:
            return (a + rng.normal(0, 0.2, a.shape)).astype(a.dtype)
        if "scale" in name:
            return (a * rng.uniform(0.5, 2.0, a.shape)).astype(a.dtype)
        if "bias" in name:
            return (a + rng.normal(0, 0.2, a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(pert, variables)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(msgpack for the JAX package and npz for the port of the perturbed
    weights, npz of the unperturbed seed:0 weights, labels, frames): the
    same weights in each package's own checkpoint format."""
    import flax.serialization

    from nnstreamer_tpu.models import get_model
    from nnstreamer_tpu_torch.models.convert import (
        from_jax_variables,
        save_state_dict,
    )

    b = get_model("mobilenet_v2", {"seed": "0", "size": "64",
                                   "width": "0.35", "classes": "16"})
    d = tmp_path_factory.mktemp("slice")
    npz_seed0 = str(d / "seed0.npz")
    save_state_dict(from_jax_variables(jax.device_get(b.params)), npz_seed0)
    variables = _perturb(jax.device_get(b.params), 5)
    msgpack = str(d / "mbv2.msgpack")
    with open(msgpack, "wb") as f:
        f.write(flax.serialization.to_bytes(variables))
    npz = str(d / "mbv2.npz")
    save_state_dict(from_jax_variables(variables), npz)
    labels = str(d / "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"label{i}" for i in range(16)) + "\n")
    # 2x2 blocks of flat colour per frame
    rng = np.random.default_rng(0)
    frames = [np.kron(rng.integers(0, 256, (2, 2, 3)),
                      np.ones((32, 32, 1))).astype(np.uint8)
              for _ in range(N_FRAMES)]
    return msgpack, npz, npz_seed0, labels, frames


def test_flagship_logits_match(weights):
    """flax's seed:0 weights as they are — the setting the JAX package's
    bf16 tolerance was set on (test_model_zoo_fused_custom)."""
    _, _, npz_seed0, _, frames = weights
    want, _ = _run(jax_pipeline, JaxBuffer,
                   _line(f"seed:0,{CUSTOM}"), frames)
    got, stats = _run(port_pipeline, PortBuffer,
                      _line(f"params:{npz_seed0},{CUSTOM}",
                            extra="accelerator=true:cpu "), frames)
    assert len(got) == len(want) == N_FRAMES // 4
    for g, w in zip(got, want):
        g, w = np.asarray(g.tensors[0]), np.asarray(w.tensors[0])
        assert g.shape == w.shape == (4, 16)
        np.testing.assert_allclose(g, w, atol=0.15, rtol=0.05)
    # one build for the one input signature (the jit_traces counterpart)
    assert stats == {"jit_traces": 1}


def test_flagship_labels_match(weights):
    msgpack, npz, _, labels, frames = weights
    want, _ = _run(jax_pipeline, JaxBuffer,
                   _line(f"params:{msgpack},postproc:argmax,{CUSTOM}",
                         labels), frames)
    got, _ = _run(port_pipeline, PortBuffer,
                  _line(f"params:{npz},postproc:argmax,{CUSTOM}", labels,
                        extra="accelerator=true:cpu "), frames)
    want_labels = [lab for b in want for lab in b.meta["label"]]
    got_labels = [lab for b in got for lab in b.meta["label"]]
    assert len(got_labels) == N_FRAMES
    assert got_labels == want_labels
    # the frames are not all one class, so the comparison has teeth
    assert len(set(want_labels)) > 1
