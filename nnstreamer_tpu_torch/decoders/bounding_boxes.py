"""bounding_boxes decoder: detection tensors → RGBA overlay video.

Parity: tensordec-boundingbox.cc + box_properties/{mobilenetssd,
mobilenetssdpp,ovdetection,yolo,mppalmdetection}.cc. Modes:

  mobilenet-ssd (alias tflite-ssd)  — SSD with box-priors file
  mobilenet-ssd-postprocess (alias tf-ssd) — post-processed SSD outputs
  ov-person-detection / ov-face-detection  — OpenVINO 7-float rows
  yolov5 / yolov8                    — YOLO grid outputs, conf/IoU options
  mp-palm-detection                  — MediaPipe palm with generated anchors

Options (tensordec-boundingbox.h:30-99): option1=mode, option2=label file,
option3=mode-specific, option4=out WIDTH:HEIGHT, option5=model WIDTH:HEIGHT,
option6=track, option7=log.

Vectorised: every mode decodes with vectorized numpy (threshold masks,
class argmax, batched box algebra) instead of the reference's per-box C
loops, and the structured results are attached as ``meta['objects']`` so
apps can consume detections without parsing the raster.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Type

import numpy as np

from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.decoders import detections as det
from nnstreamer_tpu_torch.decoders.base import Decoder, register_decoder, typed_tensors
from nnstreamer_tpu_torch.log import ElementError, logi, logw
from nnstreamer_tpu_torch.types import TensorsConfig, parse_dimension


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float32)))


def _logit(x: float) -> float:
    if x <= 0.0:
        return -math.inf
    if x >= 1.0:
        return math.inf
    return math.log(x / (1.0 - x))


def _parse_wh(param: str, what: str):
    dims = parse_dimension(param)
    if len(dims) < 2:
        raise ElementError("tensor_decoder", f"{what} needs WIDTH:HEIGHT, got {param!r}")
    return int(dims[0]), int(dims[1])


class BoxProperties:
    """Per-mode decode properties (BoxProperties, tensordec-boundingbox.h:213)."""

    NAME = "base"

    def __init__(self):
        self.i_width = 0
        self.i_height = 0
        self.total_labels = 0
        self.max_detection = 0

    def set_option_internal(self, param: str) -> None:
        pass

    def check_compatible(self, config: TensorsConfig) -> None:
        raise NotImplementedError

    def decode_boxes(self, config: TensorsConfig, tensors) -> det.Detections:
        raise NotImplementedError

    # check_tensors parity (tensordec-boundingbox.cc:373)
    def _check_tensors(self, config: TensorsConfig, limit: int) -> None:
        n = config.info.num_tensors
        if n < limit:
            raise ElementError(
                "tensor_decoder", f"{self.NAME}: needs {limit} tensors, got {n}"
            )
        if n > limit:
            logw(
                "tensor-decoder:boundingbox accepts %d or less tensors; got %d",
                limit,
                n,
            )
        for i in range(1, n):
            if config.info[i].dtype != config.info[i - 1].dtype:
                raise ElementError(
                    "tensor_decoder", f"{self.NAME}: mixed tensor dtypes"
                )


_BOX_MODES: Dict[str, Type[BoxProperties]] = {}


def register_box_mode(cls: Type[BoxProperties]) -> Type[BoxProperties]:
    """addProperties parity (tensordec-boundingbox.cc constructor registry)."""
    for name in (cls.NAME,) + getattr(cls, "ALIASES", ()):
        _BOX_MODES[name] = cls
    return cls


@register_box_mode
class MobilenetSSD(BoxProperties):
    """SSD with box priors (box_properties/mobilenetssd.cc)."""

    NAME = "mobilenet-ssd"
    ALIASES = ("tflite-ssd", "old_name_mobilenet-ssd")
    BOX_SIZE = 4
    DETECTION_MAX = 2034
    PARAMS_MAX = 6

    def __init__(self):
        super().__init__()
        # threshold, y_scale, x_scale, h_scale, w_scale, iou_threshold
        self.params = [0.5, 10.0, 10.0, 5.0, 5.0, 0.5]
        self.sigmoid_threshold = _logit(0.5)
        self.priors: Optional[np.ndarray] = None  # (4, n): ycenter,xcenter,h,w

    def set_option_internal(self, param: str) -> None:
        opts = param.split(":")[: self.PARAMS_MAX + 1]
        self._load_priors(opts[0])
        for idx in range(1, len(opts)):
            if opts[idx]:
                self.params[idx - 1] = float(opts[idx])
        self.sigmoid_threshold = _logit(self.params[0])

    def _load_priors(self, path: str) -> None:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.read().split("\n")
        if len(lines) < self.BOX_SIZE:
            raise ElementError(
                "tensor_decoder", f"box prior file {path} needs ≥{self.BOX_SIZE} lines"
            )
        rows = []
        for row in range(self.BOX_SIZE):
            vals = [
                float(w)
                for w in lines[row].replace(",", " ").replace("\t", " ").split()
                if w
            ][: self.DETECTION_MAX + 1]
            rows.append(vals)
        if len({len(r) for r in rows}) != 1:
            raise ElementError("tensor_decoder", f"inconsistent box prior file {path}")
        self.priors = np.asarray(rows, np.float32)

    def check_compatible(self, config: TensorsConfig) -> None:
        self._check_tensors(config, 2)
        d1 = config.info[0].dims
        d2 = config.info[1].dims
        if d1[0] != self.BOX_SIZE or (len(d1) > 1 and d1[1] != 1):
            raise ElementError(
                "tensor_decoder", f"mobilenet-ssd: bad box dims {d1} (want 4:1:N)"
            )
        n_det = d1[2] if len(d1) > 2 else 1
        if self.total_labels and d2[0] > self.total_labels:
            raise ElementError(
                "tensor_decoder",
                f"mobilenet-ssd: {d2[0]} labels > label file's {self.total_labels}",
            )
        if (d2[1] if len(d2) > 1 else 1) != n_det:
            raise ElementError("tensor_decoder", "mobilenet-ssd: det counts differ")
        if n_det > self.DETECTION_MAX:
            raise ElementError("tensor_decoder", f"too many detections {n_det}")
        self.max_detection = n_det

    def decode_boxes(self, config: TensorsConfig, tensors) -> det.Detections:
        if self.priors is None:
            raise ElementError("tensor_decoder", "mobilenet-ssd needs option3=priors file")
        n = self.max_detection
        boxes = np.asarray(tensors[0]).reshape(n, -1)[:, : self.BOX_SIZE]
        scores_raw = np.asarray(tensors[1]).reshape(n, -1)
        _, y_scale, x_scale, h_scale, w_scale, iou_thr = self.params

        # class_id 0 is background: argmax over classes 1.. (mobilenetssd.cc:83)
        cls_slice = scores_raw[:, 1:].astype(np.float32)
        best = np.argmax(cls_slice, axis=1)
        best_raw = cls_slice[np.arange(n), best]
        keep = best_raw >= self.sigmoid_threshold

        pri = self.priors[:, :n]
        ycenter = boxes[:, 0] / y_scale * pri[2] + pri[0]
        xcenter = boxes[:, 1] / x_scale * pri[3] + pri[1]
        h = np.exp(boxes[:, 2].astype(np.float32) / h_scale) * pri[2]
        w = np.exp(boxes[:, 3].astype(np.float32) / w_scale) * pri[3]
        ymin = ycenter - h / 2.0
        xmin = xcenter - w / 2.0

        x = np.maximum(0, (xmin * self.i_width).astype(np.int32))
        y = np.maximum(0, (ymin * self.i_height).astype(np.int32))
        width = (w * self.i_width).astype(np.int32)
        height = (h * self.i_height).astype(np.int32)
        d = det.make_detections(
            x[keep], y[keep], width[keep], height[keep],
            best[keep] + 1, _sigmoid(best_raw[keep]),
        )
        return det.nms(d, iou_thr)


@register_box_mode
class MobilenetSSDPP(BoxProperties):
    """Post-processed SSD (box_properties/mobilenetssdpp.cc): four output
    tensors (locations/classes/scores/num) selected by option3 mapping.

    Class indices are consumed as-is (mobilenetssdpp.cc:85). Producers in
    this framework (zoo ``postproc:pp`` and imported
    TFLite_Detection_PostProcess graphs) emit *background-excluded*
    indices — the TFLite op convention — so the labels file for this mode
    must not contain a background row. The raw ``mobilenet-ssd`` mode, by
    contrast, is background-inclusive (mobilenetssd.cc:83)."""

    NAME = "mobilenet-ssd-postprocess"
    ALIASES = ("tf-ssd", "old_name_mobilenet-ssd-postprocess")
    BOX_SIZE = 4
    DETECTION_MAX = 100

    def __init__(self):
        super().__init__()
        self.mapping = [3, 1, 2, 0]  # locations, classes, scores, num defaults
        self.threshold = np.finfo(np.float32).tiny

    def set_option_internal(self, param: str) -> None:
        head, _, thr = param.partition(",")
        idxs = head.split(":")
        if len(idxs) != 4 or not thr:
            raise ElementError(
                "tensor_decoder",
                'mobilenet-ssd-postprocess option3 must be "loc:cls:score:num,threshold%"',
            )
        self.mapping = [int(v) for v in idxs]
        pct = int(thr)
        if 0 <= pct <= 100:
            self.threshold = pct / 100.0

    def check_compatible(self, config: TensorsConfig) -> None:
        self._check_tensors(config, 4)
        loc_i, cls_i, score_i, num_i = self.mapping
        if config.info[num_i].dims[0] != 1:
            raise ElementError("tensor_decoder", "num tensor must be dim 1")
        n = config.info[cls_i].dims[0]
        if config.info[score_i].dims[0] != n:
            raise ElementError("tensor_decoder", "classes/scores dims differ")
        d4 = config.info[loc_i].dims
        if d4[0] != self.BOX_SIZE or (len(d4) > 1 and d4[1] != n):
            raise ElementError("tensor_decoder", f"bad locations dims {d4}")
        if n > self.DETECTION_MAX:
            raise ElementError("tensor_decoder", f"too many detections {n}")
        self.max_detection = n

    def decode_boxes(self, config: TensorsConfig, tensors) -> det.Detections:
        loc_i, cls_i, score_i, num_i = self.mapping
        num = int(np.asarray(tensors[num_i]).reshape(-1)[0])
        classes = np.asarray(tensors[cls_i]).reshape(-1)[:num]
        scores = np.asarray(tensors[score_i]).reshape(-1)[:num].astype(np.float32)
        boxes = np.asarray(tensors[loc_i]).reshape(-1, self.BOX_SIZE)[:num]
        keep = scores >= self.threshold
        # rows are [ymin, xmin, ymax, xmax] normalized (mobilenetssdpp.cc:86-93)
        y1 = np.clip(boxes[:, 0], 0, 1)
        x1 = np.clip(boxes[:, 1], 0, 1)
        y2 = np.clip(boxes[:, 2], 0, 1)
        x2 = np.clip(boxes[:, 3], 0, 1)
        return det.make_detections(
            (x1[keep] * self.i_width).astype(np.int32),
            (y1[keep] * self.i_height).astype(np.int32),
            ((x2 - x1)[keep] * self.i_width).astype(np.int32),
            ((y2 - y1)[keep] * self.i_height).astype(np.int32),
            classes[keep],
            scores[keep],
        )


@register_box_mode
class OVDetection(BoxProperties):
    """OpenVINO person/face detection (box_properties/ovdetection.cc):
    one tensor of [7]xDETECTION_MAX rows: image_id, label, conf, x_min,
    y_min, x_max, y_max; rows end at image_id < 0."""

    NAME = "ov-person-detection"
    ALIASES = ("ov-face-detection",)
    DETECTION_MAX = 200
    CONF_THRESHOLD = 0.8
    INFO_SIZE = 7

    def check_compatible(self, config: TensorsConfig) -> None:
        self._check_tensors(config, 1)
        d = config.info[0].dims
        if d[0] != self.INFO_SIZE or (len(d) > 1 and d[1] != self.DETECTION_MAX):
            raise ElementError(
                "tensor_decoder", f"ov-detection: bad dims {d} (want 7:200)"
            )
        self.max_detection = self.DETECTION_MAX

    def decode_boxes(self, config: TensorsConfig, tensors) -> det.Detections:
        rows = np.asarray(tensors[0]).reshape(-1, self.INFO_SIZE)[: self.DETECTION_MAX]
        end = np.nonzero(rows[:, 0].astype(np.int32) < 0)[0]
        if end.size:
            rows = rows[: end[0]]
        conf = rows[:, 2].astype(np.float32)
        keep = conf >= self.CONF_THRESHOLD
        rows = rows[keep]
        return det.make_detections(
            (rows[:, 3] * self.i_width).astype(np.int32),
            (rows[:, 4] * self.i_height).astype(np.int32),
            ((rows[:, 5] - rows[:, 3]) * self.i_width).astype(np.int32),
            ((rows[:, 6] - rows[:, 4]) * self.i_height).astype(np.int32),
            np.full(len(rows), -1, np.int32),
            np.ones(len(rows), np.float32),
        )


class _YoloBase(BoxProperties):
    """Shared YOLO decode (box_properties/yolo.cc). DET_INFO is the number
    of leading box fields per row (5 for v5 w/ objectness, 4 for v8)."""

    DET_INFO = 5

    def __init__(self):
        super().__init__()
        self.scaled_output = 0
        self.conf_threshold = 0.25
        self.iou_threshold = 0.45

    def set_option_internal(self, param: str) -> None:
        opts = param.split(":")
        if len(opts) > 0 and opts[0]:
            self.scaled_output = int(opts[0])
        if len(opts) > 1 and opts[1]:
            self.conf_threshold = float(opts[1])
        if len(opts) > 2 and opts[2]:
            self.iou_threshold = float(opts[2])

    def _expected_cells(self) -> int:
        return (
            (self.i_width // 32) * (self.i_height // 32)
            + (self.i_width // 16) * (self.i_height // 16)
            + (self.i_width // 8) * (self.i_height // 8)
        )

    def check_compatible(self, config: TensorsConfig) -> None:
        self._check_tensors(config, 1)
        d = config.info[0].dims
        if self.total_labels == 0 and d[0] > self.DET_INFO:
            # no label file given: infer class count from the tensor shape
            self.total_labels = d[0] - self.DET_INFO
        if d[0] != self.total_labels + self.DET_INFO:
            raise ElementError(
                "tensor_decoder",
                f"{self.NAME}: dim0 {d[0]} != labels {self.total_labels} + {self.DET_INFO}"
                " (a tensor_transform mode=transpose may help)",
            )
        if (d[1] if len(d) > 1 else 1) != self.max_detection:
            raise ElementError(
                "tensor_decoder",
                f"{self.NAME}: dim1 {d[1] if len(d) > 1 else 1} != expected boxes"
                f" {self.max_detection} for model input {self.i_width}x{self.i_height}",
            )

    def _decode_rows(self, rows: np.ndarray):
        """rows: (num_boxes, DET_INFO + labels) float32.
        Returns (keep_mask, x, y, w, h, class_id, prob)."""
        cls = rows[:, self.DET_INFO :]
        best = np.argmax(cls, axis=1)
        best_score = cls[np.arange(rows.shape[0]), best]
        if self.DET_INFO == 5:
            conf = best_score * rows[:, 4]
        else:
            conf = best_score
        keep = conf > self.conf_threshold

        cx, cy = rows[:, 0].copy(), rows[:, 1].copy()
        w, h = rows[:, 2].copy(), rows[:, 3].copy()
        if not self.scaled_output:
            cx *= self.i_width
            cy *= self.i_height
            w *= self.i_width
            h *= self.i_height
        x = np.maximum(0.0, cx - w / 2.0).astype(np.int32)
        y = np.maximum(0.0, cy - h / 2.0).astype(np.int32)
        width = np.minimum(float(self.i_width), w).astype(np.int32)
        height = np.minimum(float(self.i_height), h).astype(np.int32)
        return keep, x, y, width, height, best, conf

    def decode_boxes(self, config: TensorsConfig, tensors) -> det.Detections:
        rows = np.asarray(tensors[0], np.float32).reshape(
            self.max_detection, self.total_labels + self.DET_INFO
        )
        keep, x, y, w, h, cls, conf = self._decode_rows(rows)
        d = det.make_detections(x[keep], y[keep], w[keep], h[keep], cls[keep], conf[keep])
        return det.nms(d, self.iou_threshold)


@register_box_mode
class YoloV5(_YoloBase):
    NAME = "yolov5"
    DET_INFO = 5

    def check_compatible(self, config: TensorsConfig) -> None:
        self.max_detection = self._expected_cells() * 3
        super().check_compatible(config)


@register_box_mode
class YoloV8(_YoloBase):
    NAME = "yolov8"
    DET_INFO = 4

    def check_compatible(self, config: TensorsConfig) -> None:
        self.max_detection = self._expected_cells()
        super().check_compatible(config)


@register_box_mode
class MpPalmDetection(BoxProperties):
    """MediaPipe palm detection (box_properties/mppalmdetection.cc):
    SSD-style anchors generated from strides/scales over a 192-px grid."""

    NAME = "mp-palm-detection"
    INFO_SIZE = 18
    MAX_DETECTION = 2016
    ANCHOR_GRID = 192

    def __init__(self):
        super().__init__()
        self.min_score_threshold = 0.5
        self.num_layers = 4
        self.min_scale = 1.0
        self.max_scale = 1.0
        self.offset_x = 0.5
        self.offset_y = 0.5
        self.strides = [8, 16, 16, 16]
        self.anchors: Optional[np.ndarray] = None  # (n, 4): x_center,y_center,w,h
        self._generate_anchors()

    def set_option_internal(self, param: str) -> None:
        opts = [o for o in param.split(":")]
        if len(opts) > 13:
            raise ElementError("tensor_decoder", "mp-palm-detection: too many options")
        vals = [float(o) if o else None for o in opts]

        def take(idx, cur, conv=float):
            return conv(vals[idx]) if len(vals) > idx and vals[idx] is not None else cur

        self.min_score_threshold = take(0, self.min_score_threshold)
        self.num_layers = take(1, self.num_layers, int)
        self.min_scale = take(2, self.min_scale)
        self.max_scale = take(3, self.max_scale)
        self.offset_x = take(4, self.offset_x)
        self.offset_y = take(5, self.offset_y)
        strides = list(self.strides)
        while len(strides) < self.num_layers:
            strides.append(strides[-1] if strides else 8)
        for i in range(self.num_layers):
            strides[i] = take(6 + i, strides[i], int)
        self.strides = strides[: self.num_layers]
        self._generate_anchors()

    @staticmethod
    def _calc_scale(mn, mx, idx, n):
        if n == 1:
            return (mn + mx) * 0.5
        return mn + (mx - mn) * idx / (n - 1.0)

    def _generate_anchors(self) -> None:
        """SSD anchor generation (mp_palm_detection_generate_anchors)."""
        anchors: List[List[float]] = []
        layer_id = 0
        while layer_id < self.num_layers:
            sizes: List[float] = []
            last = layer_id
            while last < self.num_layers and self.strides[last] == self.strides[layer_id]:
                # two unit aspect-ratio anchors per same-stride layer
                sizes.append(self._calc_scale(self.min_scale, self.max_scale, last, self.num_layers))
                sizes.append(self._calc_scale(self.min_scale, self.max_scale, last + 1, self.num_layers))
                last += 1
            stride = self.strides[layer_id]
            fm = math.ceil(self.ANCHOR_GRID / stride)
            for yi in range(fm):
                for xi in range(fm):
                    for s in sizes:
                        anchors.append(
                            [(xi + self.offset_x) / fm, (yi + self.offset_y) / fm, s, s]
                        )
            layer_id = last
        self.anchors = np.asarray(anchors, np.float32)

    def check_compatible(self, config: TensorsConfig) -> None:
        self._check_tensors(config, 2)
        d1 = config.info[0].dims
        d2 = config.info[1].dims
        if d1[0] != self.INFO_SIZE or len(d1) < 2 or d1[1] <= 0:
            raise ElementError("tensor_decoder", f"mp-palm: bad box dims {d1}")
        if d2[0] != 1 or (len(d2) > 1 and d2[1] != d1[1]):
            raise ElementError("tensor_decoder", f"mp-palm: bad score dims {d2}")
        if d1[1] > self.MAX_DETECTION:
            raise ElementError("tensor_decoder", f"too many detections {d1[1]}")
        self.max_detection = d1[1]

    def decode_boxes(self, config: TensorsConfig, tensors) -> det.Detections:
        n = self.max_detection
        boxes = np.asarray(tensors[0]).reshape(n, -1).astype(np.float32)
        raw = np.asarray(tensors[1]).reshape(-1)[:n].astype(np.float32)
        score = _sigmoid(np.clip(raw, -100.0, 100.0))
        keep = score >= self.min_score_threshold

        a = self.anchors[:n]
        y_center = boxes[:, 0] / self.i_height * a[:, 3] + a[:, 1]
        x_center = boxes[:, 1] / self.i_width * a[:, 2] + a[:, 0]
        h = boxes[:, 2] / self.i_height * a[:, 3]
        w = boxes[:, 3] / self.i_width * a[:, 2]
        x = np.maximum(0, ((x_center - w / 2.0) * self.i_width).astype(np.int32))
        y = np.maximum(0, ((y_center - h / 2.0) * self.i_height).astype(np.int32))
        d = det.make_detections(
            x[keep], y[keep],
            (w * self.i_width).astype(np.int32)[keep],
            (h * self.i_height).astype(np.int32)[keep],
            np.zeros(int(keep.sum()), np.int32),
            score[keep],
        )
        return det.nms(d, 0.05)  # mppalmdetection.cc:360 nms(results, 0.05f)


@register_decoder
class BoundingBoxes(Decoder):
    MODE = "bounding_boxes"

    def init(self, options):
        super().init(options)
        opts = list(options) + [None] * 9
        mode = opts[0]
        if not mode or mode not in _BOX_MODES:
            raise ElementError(
                "tensor_decoder",
                f"bounding_boxes: unknown mode {mode!r}; available: {sorted(_BOX_MODES)}",
            )
        self.props = _BOX_MODES[mode]()
        self.labels: List[str] = []
        if opts[1]:
            self.labels = det.load_labels(opts[1])
            self.props.total_labels = len(self.labels)
        self.width = self.height = 0
        if opts[3]:
            self.width, self.height = _parse_wh(opts[3], "option4 (output size)")
        if opts[4]:
            w, h = _parse_wh(opts[4], "option5 (model input size)")
            self.props.i_width, self.props.i_height = w, h
        if opts[2]:
            self.props.set_option_internal(opts[2])
        self.is_track = bool(int(opts[5])) if opts[5] else False
        self.do_log = bool(int(opts[6])) if opts[6] else False
        self.tracker = det.CentroidTracker() if self.is_track else None

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        self.props.check_compatible(config)
        rate = (
            f",framerate={config.rate_n}/{config.rate_d}"
            if config.rate_n >= 0 and config.rate_d > 0
            else ""
        )
        return Caps.from_string(
            f"video/x-raw,format=RGBA,width={self.width},height={self.height}{rate}"
        )

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        results = self.props.decode_boxes(config, typed_tensors(buf, config))
        if self.do_log:
            logi(
                "Detect %d boxes in %d x %d input image",
                len(results), self.props.i_width, self.props.i_height,
            )
        if self.tracker is not None:
            self.tracker.update(results)
        canvas = np.zeros((self.height, self.width), np.uint32)
        det.draw_boxes(
            canvas, results,
            self.props.i_width, self.props.i_height,
            self.labels or None, track=self.is_track,
        )
        out = buf.with_tensors([canvas.view(np.uint8).reshape(self.height, self.width, 4)])
        out.meta["objects"] = results.to_list()
        return out
