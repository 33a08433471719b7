"""The port's ``postproc:pp`` detection bundles (SSD-MobileNet-v2 and
YOLOv8, with the device-side top-k and NMS of ``ops/detection.py``)
against the JAX package's on flax's seed-0 weights. Split from
tests/test_torch_vision.py, whose models and post-process cases it
shares, so that the two run in parallel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import jit_init  # noqa: E402
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")

from nnstreamer_tpu_torch.models.convert import from_jax_variables  # noqa: E402


def _jax_bundle(monkeypatch, name, cfg):
    import nnstreamer_tpu.models as jm

    monkeypatch.setattr(jm, "_init_on_cpu", jit_init)
    return jm.get_model(name, cfg)


def _matched(got, want, b, lead, tol):
    """Every one of the port's ``lead`` leading detections of frame ``b``
    has a JAX detection among the first ``lead`` + 3 with its class, its
    score within ``tol`` and its box within ``tol``."""
    for i in range(lead):
        ok = [j for j in range(min(lead + 3, want[1].shape[1]))
              if want[1][b, j] == got[1][b, i]
              and abs(want[2][b, j] - got[2][b, i]) <= tol
              and np.abs(want[0][b, j] - got[0][b, i]).max() <= tol]
        assert ok, (b, i, got[1][b, i], got[2][b, i])


@pytest.mark.parametrize("model", ["ssd_mobilenet", "yolov8"])
def test_pp_bundle_matches_jax_on_the_same_weights(monkeypatch, tmp_path,
                                                   model):
    """The ``postproc:pp`` bundles on flax's seed-0 weights carried over
    by ``.npz``: the port's quad against the JAX bundle's on the same
    uint8 frames. Both compute in bfloat16, which flips borderline
    survivors, so the rule is the reference's near agreement
    (tests/test_fused_block.py::test_ssd_zoo_fused_pp_custom): counts
    within a few, the leading detections' scores within 5e-3. The class
    scores under flax's init all lie within 1e-2 of 0.5, so the order of
    near-tied leaders is rounding: instead of classes in the same order,
    each leader must match a JAX detection of the same class, score and
    box (within 5e-3)."""
    from nnstreamer_tpu_torch.models import get_model
    from nnstreamer_tpu_torch.models.convert import save_state_dict

    size = 96 if model == "ssd_mobilenet" else 64
    cfg = ({"size": "96", "width": "0.35", "classes": "7", "pp_score": "0.1"}
           if model == "ssd_mobilenet" else
           {"size": "64", "classes": "4", "pp_score": "0.01"})
    cfg = {"seed": "0", "postproc": "pp", **cfg}
    jb = _jax_bundle(monkeypatch, model, cfg)
    npz = str(tmp_path / "w.npz")
    save_state_dict(from_jax_variables(jax.device_get(jb.params),
                                       model=model), npz)
    tb = get_model(model, {**cfg, "params": npz}, device="cpu")
    x = np.random.default_rng(7).integers(0, 256, (2, size, size, 3),
                                          np.uint8)
    want = [np.asarray(o) for o in jb.apply_fn(jb.params, x)]
    got = [o.numpy() for o in tb.apply_fn(torch.from_numpy(x))]
    assert [g.shape for g in got] == [w.shape for w in want]
    for b in range(2):
        n_want, n_got = int(want[3][b, 0]), int(got[3][b, 0])
        assert abs(n_want - n_got) <= max(3, n_want // 10), (n_want, n_got)
        lead = min(n_want, n_got, 10)
        assert lead > 0
        np.testing.assert_allclose(got[2][b, :lead], want[2][b, :lead],
                                   atol=5e-3, rtol=5e-3)
        _matched(got, want, b, lead, 5e-3)
