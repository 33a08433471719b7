"""Training SSD-MobileNet-v2 and YOLOv8 in the port against the JAX
package's trainer: the checks of tests/test_torch_train_vision.py (see
its docstring for the models' sizes, the weights and the tolerances), on
the two detection models, plus their ``postproc:pp`` bundles."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import test_torch_train_vision as tv  # noqa: E402

jax_runs = tv.jax_runs
_one_thread = tv._one_thread

NAMES = ["ssd_mobilenet", "yolov8"]


@pytest.mark.parametrize("name", NAMES)
def test_two_mse_steps_match_the_jax_trainer(jax_runs, name):
    tv.two_mse_steps(jax_runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_softmax_xent_on_a_dense_head_fails_in_both(name, monkeypatch):
    tv.softmax_xent_fails_in_both(name, monkeypatch)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_step_takes_the_model(name, monkeypatch):
    tv.mesh_step_takes_the_model(name, monkeypatch)


@pytest.mark.parametrize("name", NAMES)
def test_pp_bundle_trains_its_raw_model(name):
    tv.pp_bundle_trains_its_raw_model(name)


def test_validation_runs_the_trained_weights():
    tv.validation_runs_the_trained_weights("ssd_mobilenet")



def test_yolov8_seed_init_box_heads_as_flax_default():
    """The port's ``seed:0`` YOLOv8: its box heads' weights spread as
    flax's default kernel init (the JAX package's ``seed:`` init, the
    ``nn.Conv`` the heads are) spreads a kernel of their shape (std within
    25%), and its train forward's box sizes lie inside the decode's clamp
    (e^-10 to e^8 strides) with a log spread under 1.5. With the box heads
    at std 1 (the port's init before it followed flax's) that spread was
    4.3 here and 8% of the sizes sat at the clamp, where a bfloat16
    rounding moves the mse loss by orders of magnitude."""
    import flax.linen as nn

    from nnstreamer_tpu_torch.models import get_model

    size = 128
    tb = get_model("yolov8", {"size": str(size), "classes": "4",
                              "seed": "0"}, "cpu")
    for i, head in enumerate(tb.module.box_heads):
        c = head.weight.shape[1]
        flax_w = np.asarray(nn.Conv(4, (1, 1)).kernel_init(
            jax.random.PRNGKey(i), (1, 1, c, 4)))
        ratio = float(head.weight.detach().std()) / float(flax_w.std())
        assert 0.8 <= ratio <= 1.25, (i, c, ratio)
    frames = np.random.default_rng(21).integers(
        0, 256, (4, size, size, 3), dtype=np.uint8)
    with torch.no_grad():
        rows, _ = tb.train_apply_fn(torch.from_numpy(frames))
    strides = np.concatenate([np.full((size // s) ** 2, s, np.float64)
                              for s in (8, 16, 32)])
    logs = np.log(rows.double().numpy()[..., 2:4] / strides[:, None])
    assert ((logs > -9.99) & (logs < 7.99)).all()
    assert logs.std() < 1.5, logs.std()
