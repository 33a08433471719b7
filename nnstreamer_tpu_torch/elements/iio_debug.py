"""tensor_src_iio + tensor_debug — sensor source and stream introspection
(counterpart of the JAX package's ``elements/iio_debug.py``).

Parity:
- gsttensor_srciio.c (2603 LoC): GstBaseSrc reading Linux IIO sensors.
  Two modes here, mirroring the reference's capture paths:

  * ``mode=poll`` — poll-mode sysfs reads (the in_<channel>_raw
    interface) batched into frames; a debugging convenience.
  * ``mode=buffered`` (default, like the reference: "IIO sources are
    only supported in buffered mode", gsttensor_srciio.c:36-71) —
    full triggered + buffered chardev capture: scan_elements channel
    discovery (``in_*_en``/``_index``/``_type``), type-spec parsing
    (``le:s12/16>>4`` endian/sign/bits/shift,
    gsttensor_srciio.c:725-800), per-channel ``_scale``/``_offset``,
    trigger attach via ``trigger/current_trigger``, ``buffer/length``
    + ``buffer/enable`` arming, and binary scan decoding from
    ``/dev/iio:deviceN`` with IIO storage-aligned channel packing
    (gsttensor_get_size_from_channels, :1500-1526). Decoding is
    vectorized numpy over whole scan blocks (the reference loops
    per-value in C). Original sysfs state (_en, current_trigger,
    buffer/enable, sampling_frequency) is restored on stop, like the
    reference's NULL-state restore.

  ``base-dir`` overrides /sys/bus/iio/devices and ``dev-dir`` overrides
  /dev so tests fake both trees (the reference tests do the same via a
  mocked sysfs, tests/nnstreamer_source_iio).
- gsttensor_debug.c (441 LoC): passthrough element logging tensor
  metadata/contents (capability to taste via ``output-mode``). A torch
  tensor's metadata is read from its attributes; its contents
  (``capability=data|all``) cost one ``d2h`` crossing when it is the
  backend's, and the host copy passes on.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import Buffer, dtype_name
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.log import ElementError, get_logger
from nnstreamer_tpu_torch.pipeline.element import (
    Element,
    FlowReturn,
    Pad,
    SourceElement,
    element_register,
)

log = get_logger("element.iio")

IIO_BASE_DIR = "/sys/bus/iio/devices"
IIO_DEV_DIR = "/dev"


class IIOChannel:
    """One enabled scan channel: name, scan index, packed-storage spec
    parsed from scan_elements/in_<ch>_type (``[bl]e:[su]BITS/STORAGE>>SHIFT``,
    gsttensor_srciio.c:725-800) plus _scale/_offset calibration."""

    __slots__ = ("name", "index", "big_endian", "is_signed", "used_bits",
                 "storage_bits", "storage_bytes", "shift", "scale",
                 "offset", "location", "prior_en")

    def __init__(self, name: str, index: int, type_spec: str,
                 scale: float = 1.0, offset: float = 0.0):
        self.name = name
        self.index = index
        self.scale = scale
        self.offset = offset
        self.location = 0
        self.prior_en: Optional[str] = None
        try:
            endian, rest = type_spec.strip().split(":", 1)
            self.big_endian = endian == "be"
            if endian not in ("be", "le"):
                raise ValueError(f"bad endianness {endian!r}")
            self.is_signed = rest[0] == "s"
            if rest[0] not in ("s", "u"):
                raise ValueError(f"bad sign {rest[0]!r}")
            bits, rest = rest[1:].split("/", 1)
            store, shift = rest.split(">>", 1)
            self.used_bits = int(bits)
            self.storage_bits = int(store)
            self.shift = int(shift)
        except (ValueError, IndexError) as e:
            raise ValueError(f"unparsable IIO type spec {type_spec!r}: {e}")
        if not (0 < self.used_bits <= self.storage_bits <= 64):
            raise ValueError(f"bad bit widths in {type_spec!r}")
        if self.shift >= self.storage_bits:
            raise ValueError(f"shift exceeds storage in {type_spec!r}")
        self.storage_bytes = (self.storage_bits - 1) // 8 + 1
        # round storage up to a power-of-two container (IIO packs into
        # 1/2/4/8-byte words; e.g. 24/24>>0 is stored in 4 bytes)
        b = 1
        while b < self.storage_bytes:
            b *= 2
        self.storage_bytes = b

    def np_dtype(self) -> np.dtype:
        return np.dtype((">" if self.big_endian else "<")
                        + f"u{self.storage_bytes}")

    def decode(self, block: np.ndarray) -> np.ndarray:
        """Vectorized scan decode: ``block`` is uint8 [n_scans, scan_size];
        returns float32 [n_scans] — shift, mask to used bits, sign-extend,
        then (value + offset) * scale (PROCESS_SCANNED_DATA semantics,
        gsttensor_srciio.c:106-134)."""
        raw = block[:, self.location:self.location + self.storage_bytes]
        v = np.ascontiguousarray(raw).view(self.np_dtype())[:, 0]
        v = (v.astype(np.uint64) >> np.uint64(self.shift))
        mask = np.uint64((1 << self.used_bits) - 1)
        v = v & mask
        if self.is_signed:
            # sign-extend via shift-up + arithmetic shift-down (uniform
            # for used_bits 1..64; avoids 1<<64 overflow constants)
            sh = 64 - self.used_bits
            vs = (v << np.uint64(sh)).view(np.int64) >> np.int64(sh)
            f = vs.astype(np.float32)
        else:
            f = v.astype(np.float32)
        return (f + np.float32(self.offset)) * np.float32(self.scale)


def _scan_layout(channels: List["IIOChannel"]) -> int:
    """Assign each channel its byte offset in one scan (sorted by scan
    index, each aligned to its own storage size — the kernel's IIO
    buffer packing; gst_tensor_get_size_from_channels :1500-1526) and
    return the total scan size."""
    size = 0
    for ch in channels:
        rem = size % ch.storage_bytes
        ch.location = size if rem == 0 else size - rem + ch.storage_bytes
        size = ch.location + ch.storage_bytes
    return size


def _read_sysfs(path: str, default: Optional[str] = None) -> Optional[str]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return f.read().strip()
    except OSError:
        return default


def _write_sysfs(path: str, value: str) -> bool:
    try:
        with open(path, "w", encoding="utf-8") as f:
            f.write(value)
        return True
    except OSError:
        return False


@element_register
class TensorSrcIIO(SourceElement):
    """Props: mode ('buffered'|'poll'), device (name) or device-number,
    trigger (name) or trigger-number, channels ('auto'|'all'|comma index
    list), buffer-capacity (scans/buffer), frequency,
    merge-channels-data (bool, default true), poll-timeout (ms),
    frames-per-buffer + num-buffers (poll mode / test bound),
    base-dir (sysfs root override), dev-dir (/dev override)."""

    ELEMENT_NAME = "tensor_src_iio"
    PROPERTY_SCHEMA = {
        "mode": Prop("enum", enum=("auto", "buffered", "poll")),
        "device": Prop("str"),
        "device_number": Prop("int"),
        "trigger": Prop("str"),
        "trigger_number": Prop("int"),
        "channels": Prop("str", doc="'auto' or explicit selection"),
        "buffer_capacity": Prop("int"),
        "frequency": Prop("int"),
        "merge_channels_data": Prop("bool"),
        "frames_per_buffer": Prop("int"),
        "poll_timeout": Prop("int"),
        "num_buffers": Prop("int"),
        "base_dir": Prop("str"),
        "dev_dir": Prop("str"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._dev_dir: Optional[str] = None
        self._channels: List[str] = []
        self._count = 0
        # buffered-capture state
        self._scan_channels: List[IIOChannel] = []
        self._scan_size = 0
        self._data_fd: Optional[int] = None
        self._restore: List[tuple] = []  # (sysfs path, prior value|None)
        self._mode_resolved: Optional[str] = None
        # partial-scan bytes held across reads (poll-timeout can split a
        # scan mid-read; dropping the fragment would lose the sample)
        self._read_rem = b""
        self._saw_eof = False  # chardev hit EOF (device gone / mock drained)

    def _find_device(self, base: str, prefix: str = "iio:device",
                     name_prop: str = "device",
                     num_prop: str = "device_number") -> str:
        want_name = self.properties.get(name_prop)
        want_num = self.properties.get(num_prop)
        if want_num is not None:
            d = os.path.join(base, f"{prefix}{int(want_num)}")
            if not os.path.isdir(d):
                raise ElementError(self.name, f"no IIO entry {d}")
            return d
        if not os.path.isdir(base):
            raise ElementError(self.name, f"no IIO sysfs at {base}")
        for entry in sorted(os.listdir(base)):
            if not entry.startswith(prefix):
                continue
            d = os.path.join(base, entry)
            nm = _read_sysfs(os.path.join(d, "name"))
            if nm is not None and want_name in (None, "", nm):
                return d
        raise ElementError(
            self.name, f"IIO {name_prop} {want_name!r} not found in {base}")

    # -- buffered-mode setup (the reference's only supported mode) -------
    def _discover_scan_channels(self) -> List[IIOChannel]:
        scan_dir = os.path.join(self._dev_dir, "scan_elements")
        if not os.path.isdir(scan_dir):
            raise ElementError(
                self.name, f"device has no scan_elements dir: {scan_dir}")
        sel = str(self.properties.get("channels", "auto")).strip().lower()
        chans: List[IIOChannel] = []
        for f in sorted(os.listdir(scan_dir)):
            if not f.endswith("_en"):
                continue
            cname = f[:-3]
            idx_s = _read_sysfs(os.path.join(scan_dir, f"{cname}_index"))
            type_s = _read_sysfs(os.path.join(scan_dir, f"{cname}_type"))
            if idx_s is None or type_s is None:
                continue
            # calibration lives in the DEVICE dir (in_voltage0_scale …);
            # fall back to generic names: trailing digits stripped
            # (in_voltage0 → in_voltage, the reference's
            # get_generic_name :800-818) and a trailing _x/_y/_z axis
            # stripped (in_accel_x → in_accel — real accelerometers
            # share one in_accel_scale across axes)
            candidates = [cname]
            digitless = cname.rstrip("0123456789")
            if digitless != cname:
                candidates.append(digitless)
            parts = cname.rsplit("_", 1)
            if len(parts) == 2 and parts[1] in ("x", "y", "z"):
                candidates.append(parts[0])
            scale = offset = None
            for nm in candidates:
                if scale is None:
                    scale = _read_sysfs(
                        os.path.join(self._dev_dir, f"{nm}_scale"))
                if offset is None:
                    offset = _read_sysfs(
                        os.path.join(self._dev_dir, f"{nm}_offset"))
            try:
                ch = IIOChannel(cname, int(idx_s), type_s,
                                float(scale) if scale else 1.0,
                                float(offset) if offset else 0.0)
            except ValueError as e:
                raise ElementError(self.name, str(e))
            ch.prior_en = _read_sysfs(os.path.join(scan_dir, f))
            chans.append(ch)
        if not chans:
            raise ElementError(self.name, f"no scan channels in {scan_dir}")
        chans.sort(key=lambda c: c.index)
        if sel == "auto":
            # keep the device's pre-enabled set (reference
            # CHANNELS_ENABLED_AUTO); if nothing is pre-enabled, use all
            pre = [c for c in chans if (c.prior_en or "0").strip() == "1"]
            return pre or chans
        if sel == "all":
            return chans
        # explicit list: scan indexes (reference convention) or channel
        # names, mixed freely; names accept the bare form too ('accel_x'
        # matches in_accel_x, keeping poll-mode launch lines working)
        got, missing = [], []
        by_name = {c.name: c for c in chans}
        by_name.update({c.name[3:]: c for c in chans
                        if c.name.startswith("in_")})
        by_index = {c.index: c for c in chans}
        for t in (t.strip() for t in sel.split(",")):
            if not t:
                continue
            c = by_index.get(int(t)) if t.isdigit() else by_name.get(t)
            if c is None:
                missing.append(t)
            elif c not in got:
                got.append(c)
        if missing or not got:
            raise ElementError(
                self.name, f"channels {missing or [sel]} not found "
                f"(have indexes {[c.index for c in chans]}, "
                f"names {[c.name for c in chans]})")
        got.sort(key=lambda c: c.index)
        return got

    def _push_restore(self, path: str) -> None:
        self._restore.append((path, _read_sysfs(path)))

    def _setup_buffered(self) -> None:
        scan_dir = os.path.join(self._dev_dir, "scan_elements")
        all_en = sorted(
            f for f in os.listdir(scan_dir) if f.endswith("_en"))
        selected = {c.name for c in self._scan_channels}
        for f in all_en:
            path = os.path.join(scan_dir, f)
            self._push_restore(path)
            _write_sysfs(path, "1" if f[:-3] in selected else "0")
        # sampling frequency (only when the device exposes the knob)
        freq = int(self.properties.get("frequency", 0))
        fpath = os.path.join(self._dev_dir, "sampling_frequency")
        if freq > 0 and os.path.isfile(fpath):
            self._push_restore(fpath)
            _write_sysfs(fpath, str(freq))
        # trigger attach (trigger/current_trigger ← trigger's name file)
        trig_name = self.properties.get("trigger")
        trig_num = self.properties.get("trigger_number")
        if trig_name or trig_num is not None:
            base = os.path.dirname(self._dev_dir)
            tdir = self._find_device(base, prefix="trigger",
                                     name_prop="trigger",
                                     num_prop="trigger_number")
            tname = _read_sysfs(os.path.join(tdir, "name"))
            cur = os.path.join(self._dev_dir, "trigger", "current_trigger")
            self._push_restore(cur)
            if not _write_sysfs(cur, tname or ""):
                raise ElementError(
                    self.name, f"cannot set trigger {tname!r} on {cur}")
        # arm the buffer: length (scans) then enable
        cap = int(self.properties.get("buffer_capacity", 1))
        blen = os.path.join(self._dev_dir, "buffer", "length")
        ben = os.path.join(self._dev_dir, "buffer", "enable")
        if os.path.isfile(blen):
            self._push_restore(blen)
            _write_sysfs(blen, str(cap))
        self._push_restore(ben)
        if not _write_sysfs(ben, "1"):
            raise ElementError(self.name, f"cannot enable IIO buffer {ben}")
        # open the chardev that streams the armed buffer's scans
        devname = os.path.basename(self._dev_dir)
        data_path = os.path.join(
            str(self.properties.get("dev_dir", IIO_DEV_DIR)), devname)
        try:
            self._data_fd = os.open(data_path, os.O_RDONLY)
        except OSError as e:
            raise ElementError(
                self.name, f"cannot open IIO data chardev {data_path}: {e}")

    def _mode(self) -> str:
        """'buffered' | 'poll'; default 'auto' resolves ONCE at start to
        buffered when the device exposes scan_elements (the reference's
        only supported path), poll otherwise (raw-only sysfs trees)."""
        if self._mode_resolved is not None:
            return self._mode_resolved
        m = str(self.properties.get("mode", "auto"))
        if m == "auto":
            m = ("buffered" if self._dev_dir and os.path.isdir(
                os.path.join(self._dev_dir, "scan_elements")) else "poll")
        self._mode_resolved = m
        return m

    def start(self) -> None:
        base = str(self.properties.get("base_dir", IIO_BASE_DIR))
        self._dev_dir = self._find_device(base)
        self._count = 0
        self._restore = []
        self._mode_resolved = None
        self._read_rem = b""  # stale fragments must not shift a new run
        self._saw_eof = False
        if self._mode() == "buffered":
            self._scan_channels = self._discover_scan_channels()
            self._scan_size = _scan_layout(self._scan_channels)
            self._setup_buffered()
            return
        sel = str(self.properties.get("channels", "auto"))
        if sel in ("auto", "all"):
            self._channels = sorted(
                f
                for f in os.listdir(self._dev_dir)
                if f.startswith("in_") and f.endswith("_raw")
            )
        else:
            self._channels = [f"in_{c}_raw" for c in sel.split(",") if c]
        if not self._channels:
            raise ElementError(self.name, f"no scan channels in {self._dev_dir}")

    def stop(self) -> None:
        if self._data_fd is not None:
            try:
                os.close(self._data_fd)
            except OSError:
                pass
            self._data_fd = None
        # NULL-state restore, reverse order so buffer/enable drops first
        # (the reference restores the device's original configuration on
        # the PLAYING→NULL path)
        for path, prior in reversed(self._restore):
            if prior is not None:
                _write_sysfs(path, prior)
            elif path.endswith(os.path.join("buffer", "enable")):
                _write_sysfs(path, "0")
        self._restore = []

    def negotiate(self) -> Caps:
        if self._mode() == "buffered":
            # reference caps contract (gsttensor_srciio.c:55-61): merged →
            # one tensor, dim0 = channel number, dim1 = buffer capacity;
            # unmerged → one tensor per channel of dim capacity
            n = len(self._scan_channels)
            cap = int(self.properties.get("buffer_capacity", 1))
            freq = int(self.properties.get("frequency", 0))
            rate = f"{freq}/1" if freq > 0 else "0/1"
            if self.properties.get("merge_channels_data", True):
                return Caps.from_string(
                    "other/tensors,format=static,num_tensors=1,"
                    f"dimensions={n}:{cap},types=float32,framerate={rate}")
            dims = ".".join([str(cap)] * n)
            types = ".".join(["float32"] * n)
            return Caps.from_string(
                f"other/tensors,format=static,num_tensors={n},"
                f"dimensions={dims},types={types},framerate={rate}")
        # poll mode: default 10 Hz, explicit 0 = unthrottled
        # (advertised as unknown rate 0/1)
        freq = int(self.properties.get("frequency", 10))
        fpb = int(self.properties.get("frames_per_buffer", 1))
        n = len(self._channels)
        rate = f"{freq}/{max(1, fpb)}" if freq > 0 else "0/1"
        return Caps.from_string(
            "other/tensors,format=static,num_tensors=1,"
            f"dimensions={n}:{fpb},types=float32,framerate={rate}"
        )

    def _read_scans(self, nbytes: int) -> Optional[bytes]:
        """One bounded read round: up to ``nbytes`` from the data chardev,
        one poll-timeout (ms) per poll cycle. Returns any COMPLETE scans
        read this round (split-scan fragments are HELD in ``_read_rem``
        for the next round, never dropped); None when nothing whole
        arrived. Sets ``_saw_eof`` on EOF (device gone / mock drained).
        A regular file stand-in (tests) reads straight through."""
        import select

        timeout_ms = int(self.properties.get("poll_timeout", 10000))
        out = bytearray(self._read_rem)
        self._read_rem = b""
        while len(out) < nbytes:
            r, _, _ = select.select([self._data_fd], [], [],
                                    max(timeout_ms, 0) / 1000.0)
            if not r:
                log.warning("%s: poll timeout (%d ms) on IIO chardev",
                            self.name, timeout_ms)
                break
            chunk = os.read(self._data_fd, nbytes - len(out))
            if not chunk:
                self._saw_eof = True  # device gone / mock exhausted
                break
            out.extend(chunk)
        whole = (len(out) // self._scan_size) * self._scan_size
        if whole < len(out):
            self._read_rem = bytes(out[whole:])
        if whole == 0:
            return None
        return bytes(out[:whole])

    def _read_frame(self) -> np.ndarray:
        vals = []
        for ch in self._channels:
            try:
                with open(os.path.join(self._dev_dir, ch), "r", encoding="utf-8") as f:
                    vals.append(float(f.read().strip() or 0))
            except (OSError, ValueError):
                vals.append(0.0)
        return np.asarray(vals, np.float32)

    def create(self) -> Optional[Buffer]:
        nb = int(self.properties.get("num_buffers", -1))
        if 0 <= nb <= self._count:
            return None
        if self._mode() == "buffered":
            cap = int(self.properties.get("buffer_capacity", 1))
            cap_bytes = self._scan_size * cap
            # accumulate whole scans until the block fills: a poll
            # timeout with the stream still flowing HOLDS the partial
            # block and keeps waiting — a slow device (inter-scan gap >
            # poll-timeout) must neither emit a short buffer (caps
            # violation) nor a padded one (fabricated samples);
            # _read_scans warns on every empty round. Termination stays
            # bounded: EOF, or 3 CONSECUTIVE empty poll rounds (a real
            # chardev never EOFs — a stalled/stopped device must not
            # hang create() forever), ends the block and pads it. The
            # contract: a device silent for 3×poll-timeout is treated as
            # stalled — size poll-timeout ABOVE the slowest expected
            # inter-scan gap or the pad duplicates real samples.
            data = bytearray()
            empty_rounds = 0
            while (len(data) < cap_bytes and not self._saw_eof
                   and empty_rounds < 3):
                got = self._read_scans(cap_bytes - len(data))
                if got is None:
                    empty_rounds += 1
                    continue
                empty_rounds = 0
                data.extend(got)
            if not data:
                return None
            n_scans = len(data) // self._scan_size
            if n_scans < cap:
                # tail guarantee: the negotiated caps promise EXACTLY
                # buffer-capacity scans per buffer (dimensions={n}:{cap});
                # pad the final partial block by repeating its last scan
                # (the reference pushes fixed buffer_capacity scans) so
                # static-shape downstream elements never see a short dim
                log.warning("%s: padding partial tail block (%d/%d scans)",
                            self.name, n_scans, cap)
                data = data + data[-self._scan_size:] * (cap - n_scans)
            data = bytes(data)
            block = np.frombuffer(data, np.uint8).reshape(
                len(data) // self._scan_size, self._scan_size)
            cols = [ch.decode(block) for ch in self._scan_channels]
            self._count += 1
            if self.properties.get("merge_channels_data", True):
                # [capacity, channels] row-major == dim0 channels (inner),
                # dim1 capacity — the reference's merged layout
                return Buffer(tensors=[np.stack(cols, axis=1)])
            return Buffer(tensors=[c.copy() for c in cols])
        fpb = int(self.properties.get("frames_per_buffer", 1))
        # default 10 Hz pacing; an explicit frequency=0 opts into unthrottled
        freq = int(self.properties.get("frequency", 10))
        frames = []
        for _ in range(fpb):
            frames.append(self._read_frame())
            if freq > 0:
                time.sleep(1.0 / freq)
        self._count += 1
        return Buffer(tensors=[np.stack(frames) if fpb > 1 else frames[0]])


@element_register
class TensorDebug(Element):
    """Passthrough printing tensor metadata (and optionally contents).
    Props: output-mode (console|log), capability (metadata|data|all)."""

    ELEMENT_NAME = "tensor_debug"
    SINK_TEMPLATE = "other/tensors"
    SRC_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "output_mode": Prop("enum", enum=("console", "log")),
        "capability": Prop("enum", enum=("metadata", "data", "all")),
    }

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        cap = str(self.properties.get("capability", "metadata"))
        if cap in ("data", "all"):
            buf = self._fetch_to_host(buf)  # contents are read on the host
        parts = []
        for i, t in enumerate(buf.tensors):
            if isinstance(t, (bytes, bytearray, memoryview)):
                parts.append(f"[{i}] bytes({len(t)})")
            else:
                if not hasattr(t, "shape"):
                    t = np.asarray(t)
                desc = f"[{i}] {dtype_name(t)}{list(t.shape)}"
                if cap in ("data", "all"):
                    flat = np.asarray(t).reshape(-1)
                    desc += f" data={flat[:8].tolist()}{'...' if flat.size > 8 else ''}"
                parts.append(desc)
        msg = f"pts={buf.pts} " + " ".join(parts)
        if str(self.properties.get("output_mode", "log")) == "console":
            print(f"{self.name}: {msg}")
        else:
            log.info("%s: %s", self.name, msg)
        return self.push(buf)
