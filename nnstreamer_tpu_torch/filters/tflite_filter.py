"""TensorFlow-Lite and TensorFlow filter backends (counterpart of the JAX
package's ``filters/tflite_filter.py``).

Reference counterparts: tensor_filter_tensorflow_lite.cc (the headline
backend — TFLite Interpreter with delegate selection, model reload
:59-122, `TFLiteInterpreter` wrapper :158) and tensor_filter_tensorflow.cc
(TF session). Here the interpreter is TF's bundled ``tf.lite.Interpreter``
(XNNPACK-accelerated CPU path); SavedModels run through
``tf.saved_model.load``. These are *compatibility* backends on the CPU —
existing .tflite/SavedModel assets run unchanged where TensorFlow is
installed; they register always and raise at open() by name where it is
not (as on the card's machine). The card's path for a .tflite file is
``framework=jax model=foo.tflite`` (tools/import_tflite.py).

custom= keys: ``num_threads:<n>`` (tflite), ``signature:<name>``
(saved-model, default 'serving_default').
"""

from __future__ import annotations

import os
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.analysis import lockwitness
from nnstreamer_tpu_torch.filters.base import FilterFramework, FilterProperties
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo

log = get_logger("filter.tflite")


def _tf():
    try:
        import tensorflow as tf  # lazy: ~10s import
    except ImportError as e:
        raise RuntimeError(
            "tensorflow is not installed in this environment; run .tflite "
            "models with framework=jax (the .tflite importer), or install "
            "tensorflow") from e
    return tf


class TFLiteFilter(FilterFramework):
    """`.tflite` models via the TFLite interpreter (XNNPACK CPU)."""

    NAME = "tensorflow-lite"
    RESHAPABLE = True  # interpreter.resize_tensor_input

    def __init__(self):
        super().__init__()
        self._interp = None
        self._in_details = None
        self._out_details = None
        self._resized: Optional[list] = None  # negotiated input shapes
        # interpreter is not thread-safe; invoke_ok/blocking_ok —
        # serializing invokes on it is this lock's entire purpose
        self._lock = lockwitness.make_lock("tflite.interp",
                                           blocking_ok=True, invoke_ok=True)

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        model = props.model_file
        if not model or not os.path.exists(model):
            raise ValueError(f"tflite model not found: {model!r}")
        custom = props.custom_dict()
        self._num_threads = int(custom.get("num_threads", 2))
        self._load(model)

    def _load(self, model: str) -> None:
        tf = _tf()
        self._interp = tf.lite.Interpreter(
            model_path=model, num_threads=self._num_threads
        )
        if self._resized:
            # a reload must keep the shapes the pipeline negotiated
            for d, shape in zip(self._interp.get_input_details(), self._resized):
                self._interp.resize_tensor_input(d["index"], shape)
        self._interp.allocate_tensors()
        self._in_details = self._interp.get_input_details()
        self._out_details = self._interp.get_output_details()

    def close(self) -> None:
        self._interp = None
        super().close()

    def handle_event(self, event_type: str, data: Optional[dict] = None) -> None:
        """RELOAD_MODEL: swap in a new .tflite without tearing the pipeline
        (is-updatable + reloadModel, nnstreamer_plugin_api_filter.h:351-357,
        tensor_filter_tensorflow_lite.cc model reload)."""
        if event_type == "reload_model":
            model = (data or {}).get("model") or self.props.model_file
            with self._lock:
                self._load(model)
            return
        super().handle_event(event_type, data)

    @staticmethod
    def _detail_info(details) -> TensorsInfo:
        return TensorsInfo(
            tensors=[
                TensorInfo.from_np_shape(
                    [int(x) for x in d["shape"]], np.dtype(d["dtype"])
                )
                for d in details
            ]
        )

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        return self._detail_info(self._in_details), self._detail_info(self._out_details)

    def set_input_info(self, in_info: TensorsInfo) -> Tuple[TensorsInfo, TensorsInfo]:
        with self._lock:
            self._resized = [t.np_shape() for t in in_info]
            for d, t in zip(self._in_details, in_info):
                self._interp.resize_tensor_input(d["index"], t.np_shape())
            self._interp.allocate_tensors()
            self._in_details = self._interp.get_input_details()
            self._out_details = self._interp.get_output_details()
        return self.get_model_info()

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        if len(inputs) != len(self._in_details):
            raise ValueError(
                f"model wants {len(self._in_details)} input tensors, got {len(inputs)}"
            )
        t0 = time.perf_counter()
        with self._lock:
            for d, x in zip(self._in_details, inputs):
                a = np.asarray(x, dtype=d["dtype"]).reshape(d["shape"])
                self._interp.set_tensor(d["index"], a)
            self._interp.invoke()
            out = [self._interp.get_tensor(d["index"]) for d in self._out_details]
        self.stats.record((time.perf_counter() - t0) * 1e6)
        return out


class TensorFlowFilter(FilterFramework):
    """TF SavedModel directories via their serving signature, and frozen
    TF1 GraphDef .pb files via named tensors (inputname=/outputname= —
    the reference's mnist.pb contract, tensor_filter_tensorflow.cc:
    explicit input/output dims + tensor names required)."""

    NAME = "tensorflow"

    def __init__(self):
        super().__init__()
        self._fn = None
        self._frozen = None
        self._in_keys: List[str] = []
        self._out_keys: List[str] = []

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        model = props.model_file
        if not model or not os.path.exists(model):
            raise ValueError(f"saved-model not found: {model!r}")
        tf = _tf()
        if os.path.isfile(model):
            self._open_frozen(tf, model, props)
            return
        sig = props.custom_dict().get("signature", "serving_default")
        loaded = tf.saved_model.load(model)
        if sig not in loaded.signatures:
            raise ValueError(
                f"signature {sig!r} not in model (has {list(loaded.signatures)})"
            )
        self._loaded = loaded  # keep alive: signatures hold weakrefs
        self._fn = loaded.signatures[sig]
        spec = self._fn.structured_input_signature[1]
        self._in_keys = sorted(spec)
        self._in_spec = spec
        self._out_spec = self._fn.structured_outputs
        self._out_keys = sorted(self._out_spec)

    def _open_frozen(self, tf, model: str, props: FilterProperties) -> None:
        """Frozen GraphDef: wrap+prune to the named feed/fetch tensors."""
        in_info, out_info = props.input_info, props.output_info
        in_names = [t.name for t in (in_info or []) if t.name]
        out_names = [t.name for t in (out_info or []) if t.name]
        if (not in_names or not out_names
                or len(in_names) != len(in_info.tensors)
                or len(out_names) != len(out_info.tensors)):
            raise ValueError(
                "frozen GraphDef needs explicit input=/inputtype=/inputname="
                " and output=/outputtype=/outputname= (the reference's "
                "tensorflow filter contract)"
            )
        gd = tf.compat.v1.GraphDef()
        with open(model, "rb") as fh:
            gd.ParseFromString(fh.read())

        def _import():
            tf.compat.v1.import_graph_def(gd, name="")

        wrapped = tf.compat.v1.wrap_function(_import, [])

        def tname(n: str) -> str:
            return n if ":" in n else n + ":0"

        feeds = [wrapped.graph.get_tensor_by_name(tname(n)) for n in in_names]
        fetches = [wrapped.graph.get_tensor_by_name(tname(n))
                   for n in out_names]
        self._frozen = wrapped.prune(feeds, fetches)
        self._frozen_in = in_info
        self._frozen_out = out_info
        # declared dtypes must match the graph's — the reference's
        # tensorflow filter errors at open on a type mismatch
        # (tensor_filter_tensorflow.cc); shipping the graph's real dtype
        # under wrongly-declared caps would corrupt downstream
        # DT_STRING feeds take the ENTIRE wire buffer as one scalar string
        # (the reference's speech-commands recipe: conv_actions_frozen.pb
        # wav_data ← whole yes.wav bytes; tensor_filter_tensorflow.cc
        # DT_STRING handling) — the declared dims then describe only the
        # wire layout, so dtype validation skips those feeds
        self._frozen_string_feed = [t.dtype == tf.string for t in feeds]
        for what, tensors, infos in (("input", feeds, in_info),
                                     ("output", fetches, out_info)):
            for t, ti in zip(tensors, infos):
                if what == "input" and t.dtype == tf.string:
                    continue  # string FEEDS take raw bytes; fetches don't
                    # get special handling, so they must type-check
                want = ti.dtype.np_dtype
                got = t.dtype.as_numpy_dtype
                if np.dtype(want) != np.dtype(got):
                    raise ValueError(
                        f"{what} tensor {t.name!r} is "
                        f"{np.dtype(got).name} in the graph but declared "
                        f"{np.dtype(want).name}"
                    )
                # declared element count must fit the graph's KNOWN dims
                # (open-time error, tensor_filter_tensorflow.cc contract —
                # not an opaque mid-stream reshape failure)
                if t.shape.rank is not None:
                    known = [int(d) for d in t.shape.as_list()
                             if d is not None]
                    if known:
                        graph_n = int(np.prod(known))
                        decl_n = int(np.prod([d for d in ti.dims if d]))
                        if decl_n % max(graph_n, 1):
                            raise ValueError(
                                f"{what} tensor {t.name!r}: declared dims "
                                f"{ti.dims} ({decl_n} elements) do not fit "
                                f"the graph shape {t.shape.as_list()}"
                            )
        # graph placeholder shapes (unknown dims -> -1): the wire layout
        # trims batch-1 dims, the graph may not (e.g. mnist.pb (?, 784)).
        # Unknown graph dims fill from the DECLARED full dims when the
        # ranks line up, so multi-unknown placeholders still reshape.
        self._frozen_shapes = []
        for t, ti in zip(feeds, in_info):
            dims = t.shape.as_list() if t.shape.rank is not None else None
            if dims is None:
                self._frozen_shapes.append(None)
                continue
            declared = [int(d) for d in reversed(ti.dims)
                        if d][-len(dims):] if dims else []
            shape = []
            for i, d in enumerate(dims):
                if d is not None:
                    shape.append(int(d))
                elif len(declared) == len(dims):
                    shape.append(declared[i])
                else:
                    shape.append(-1)
            self._frozen_shapes.append(shape)

    def close(self) -> None:
        self._fn = None
        self._frozen = None
        self._loaded = None
        super().close()

    @staticmethod
    def _specs_info(specs, keys) -> Optional[TensorsInfo]:
        tensors = []
        for k in keys:
            s = specs[k]
            shape = [int(d) if d is not None else 0 for d in s.shape]
            if any(d == 0 for d in shape):
                return None  # dynamic: negotiate via set_input_info
            tensors.append(
                TensorInfo.from_np_shape(shape, s.dtype.as_numpy_dtype, name=k)
            )
        return TensorsInfo(tensors=tensors)

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        if self._frozen is not None:
            return self._frozen_in, self._frozen_out
        return (
            self._specs_info(self._in_spec, self._in_keys),
            self._specs_info(self._out_spec, self._out_keys),
        )

    def set_input_info(self, in_info: TensorsInfo) -> Tuple[TensorsInfo, TensorsInfo]:
        tf = _tf()
        feeds = {
            k: tf.zeros(t.np_shape(), dtype=self._in_spec[k].dtype)
            for k, t in zip(self._in_keys, in_info)
        }
        outs = self._fn(**feeds)
        out_info = TensorsInfo(
            tensors=[
                TensorInfo.from_np_shape(
                    outs[k].shape, outs[k].dtype.as_numpy_dtype, name=k
                )
                for k in sorted(outs)
            ]
        )
        return in_info, out_info

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        tf = _tf()
        t0 = time.perf_counter()
        if self._frozen is not None:
            feeds = []
            for x, t, shape, is_str in zip(inputs, self._frozen_in,
                                           self._frozen_shapes,
                                           self._frozen_string_feed):
                if is_str:
                    # whole wire buffer as one scalar string tensor
                    feeds.append(tf.constant(np.asarray(x).tobytes()))
                    continue
                a = np.asarray(x, dtype=t.dtype.np_dtype)
                if shape is not None and shape.count(-1) <= 1:
                    a = a.reshape(shape)
                # >1 unknown even after filling from declared dims: pass
                # the wire-shaped array through as-is
                feeds.append(tf.convert_to_tensor(a))
            outs = self._frozen(*feeds)
            res = [np.asarray(o) for o in outs]
            self.stats.record((time.perf_counter() - t0) * 1e6)
            return res
        feeds = {
            k: tf.convert_to_tensor(
                np.asarray(x, dtype=self._in_spec[k].dtype.as_numpy_dtype)
            )
            for k, x in zip(self._in_keys, inputs)
        }
        outs = self._fn(**feeds)
        res = [outs[k].numpy() for k in sorted(outs)]
        self.stats.record((time.perf_counter() - t0) * 1e6)
        return res


registry.register(registry.FILTER, "tensorflow-lite")(TFLiteFilter)
registry.register(registry.FILTER, "tensorflow2-lite")(TFLiteFilter)
registry.register(registry.FILTER, "tensorflow1-lite")(TFLiteFilter)
registry.register(registry.FILTER, "tflite")(TFLiteFilter)
registry.register(registry.FILTER, "tensorflow")(TensorFlowFilter)
