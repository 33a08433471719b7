"""L2 logging with backtrace-augmented fatal errors.

Mirrors the reference's ``ml_logi/w/e/d/f`` macro family and its
stacktrace-on-fatal behavior (nnstreamer_log.h:25-80,
``_backtrace_to_string`` nnstreamer_log.c:35-64, used via
GST_ELEMENT_ERROR_BTRACE in tensor_filter.c:577,592).
"""

from __future__ import annotations

import logging
import os
import traceback
from typing import Optional

_logger = logging.getLogger("nnstreamer_tpu_torch")
if not _logger.handlers:
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter("[%(levelname).1s] %(name)s: %(message)s"))
    _logger.addHandler(h)
    _lvl = os.environ.get("NNS_TPU_LOG_LEVEL", "WARNING").upper()
    if _lvl not in ("CRITICAL", "FATAL", "ERROR", "WARNING", "WARN", "INFO", "DEBUG"):
        _lvl = "WARNING"  # a logging knob must not crash the import
    _logger.setLevel(_lvl)


def get_logger(name: str = "") -> logging.Logger:
    return _logger.getChild(name) if name else _logger


def logd(msg: str, *args) -> None:
    _logger.debug(msg, *args)


def logi(msg: str, *args) -> None:
    _logger.info(msg, *args)


def logw(msg: str, *args) -> None:
    _logger.warning(msg, *args)


def loge(msg: str, *args) -> None:
    _logger.error(msg, *args)


def logf(msg: str, *args) -> None:
    """Fatal: log with an attached backtrace (ml_logf_stacktrace parity)."""
    bt = "".join(traceback.format_stack()[:-1])
    _logger.critical((msg % args if args else msg) + "\nbacktrace:\n" + bt)


def format_backtrace(err: Optional[BaseException] = None) -> str:
    """Backtrace string for a fatal bus message — the
    GST_ELEMENT_ERROR_BTRACE analogue (nnstreamer_log.h:25-80): the
    exception's own traceback when it has one, else the current stack
    (``_backtrace_to_string`` nnstreamer_log.c:35-64)."""
    if err is not None and err.__traceback__ is not None:
        return "".join(
            traceback.format_exception(type(err), err, err.__traceback__))
    return "".join(traceback.format_stack()[:-1])


class ElementError(RuntimeError):
    """Element-scoped error carrying the failing element name — the analogue
    of GST_ELEMENT_ERROR with backtrace (nnstreamer_log.h GST_ELEMENT_ERROR_BTRACE).
    """

    def __init__(self, element: str, msg: str):
        super().__init__(f"{element}: {msg}")
        self.element = element
