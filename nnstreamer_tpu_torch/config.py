"""L2 layered configuration.

Mirrors the reference's 3-layer config precedence — **env var > ini file >
hardcoded default** (nnstreamer_conf.h:23-29, nnstreamer_conf.c:373+) — with
the same concepts: per-subplugin-type search paths, framework priority lists
keyed by model-file extension (``framework_priority_tflite`` etc. in
nnstreamer.ini.in), free-form custom key/value sections
(nnsconf_get_custom_value_*, nnstreamer_conf.c:575).

Env vars:
  NNS_TPU_CONF       path to ini file (default /etc/nnstreamer_tpu.ini,
                     then ~/.config/nnstreamer_tpu.ini)
  NNS_TPU_FILTERS / NNS_TPU_DECODERS / NNS_TPU_CONVERTERS / NNS_TPU_TRAINERS
                     ':'-separated extra module search paths
  NNS_TPU_<SECTION>_<KEY>  override any ini value
"""

from __future__ import annotations

import configparser
import os
import threading
from typing import Dict, List, Optional

_ENV_CONF = "NNS_TPU_CONF"
_DEFAULT_CONF_PATHS = [
    "/etc/nnstreamer_tpu.ini",
    os.path.expanduser("~/.config/nnstreamer_tpu.ini"),
]

_HARDCODED: Dict[str, Dict[str, str]] = {
    "common": {"enable_envvar": "true"},
    "filter": {"priority_tflite": "tensorflow-lite,jax",
               "priority_onnx": "jax",
               "priority_so": "custom",
               "priority_pt": "torch,jax", "priority_pth": "torch,jax",
               "priority_msgpack": "jax",
               "priority_py": "python3"},
    "decoder": {},
    "converter": {},
    "trainer": {"priority_json": "jax"},
    "filter-aliases": {"jax_xla": "jax", "xla": "jax", "pjrt": "jax",
                       "auto": "", "tensorflow2-lite": "jax"},
}

_SUBPLUGIN_PATH_ENVS = {
    "filter": "NNS_TPU_FILTERS",
    "decoder": "NNS_TPU_DECODERS",
    "converter": "NNS_TPU_CONVERTERS",
    "trainer": "NNS_TPU_TRAINERS",
}


class Conf:
    """Loaded configuration with the env > ini > default lookup."""

    def __init__(self, ini_path: Optional[str] = None):
        self._parser = configparser.ConfigParser()
        self.ini_path = None
        candidates = [ini_path] if ini_path else (
            ([os.environ[_ENV_CONF]] if _ENV_CONF in os.environ else [])
            + _DEFAULT_CONF_PATHS
        )
        for p in candidates:
            if p and os.path.isfile(p):
                self._parser.read(p)
                self.ini_path = p
                break

    def get(self, section: str, key: str, default: Optional[str] = None) -> Optional[str]:
        """nnsconf_get_custom_value_string parity with env override."""
        if self._envvar_enabled():
            env = f"NNS_TPU_{section.upper().replace('-', '_')}_{key.upper().replace('-', '_')}"
            if env in os.environ:
                return os.environ[env]
        try:
            return self._parser.get(section, key)
        except (configparser.NoSectionError, configparser.NoOptionError):
            pass
        return _HARDCODED.get(section, {}).get(key, default)

    def get_bool(self, section: str, key: str, default: bool = False) -> bool:
        v = self.get(section, key)
        if v is None:
            return default
        return v.strip().lower() in ("1", "true", "yes", "on")

    def _envvar_enabled(self) -> bool:
        # the release-build env-var kill switch (nnstreamer_conf.c enable_envvar)
        try:
            return self._parser.get("common", "enable_envvar").strip().lower() not in (
                "0", "false", "no", "off")
        except (configparser.NoSectionError, configparser.NoOptionError):
            return True

    def subplugin_paths(self, sp_type: str) -> List[str]:
        """Module search paths for a subplugin type: env paths first, then ini
        ``[<type>] path=`` entries (nnsconf_get_fullpath search order)."""
        out: List[str] = []
        env = _SUBPLUGIN_PATH_ENVS.get(sp_type)
        if env and self._envvar_enabled() and env in os.environ:
            out += [p for p in os.environ[env].split(":") if p]
        ini = self.get(sp_type, "path")
        if ini:
            out += [p for p in ini.split(":") if p]
        return out

    def framework_priority(self, model_ext: str) -> List[str]:
        """Framework priority list for a model extension
        (gst_tensor_filter_detect_framework, tensor_filter_common.c:1224-1270)."""
        v = self.get("filter", f"priority_{model_ext.lstrip('.').lower()}")
        return [f.strip() for f in v.split(",") if f.strip()] if v else []

    def resolve_alias(self, name: str) -> str:
        """[filter-aliases] section (nnstreamer.ini.in filter-aliases)."""
        v = self.get("filter-aliases", name)
        return v if v is not None else name


_lock = threading.Lock()
_conf: Optional[Conf] = None


def conf() -> Conf:
    global _conf
    with _lock:
        if _conf is None:
            _conf = Conf()
        return _conf


def reload_conf(ini_path: Optional[str] = None) -> Conf:
    global _conf
    with _lock:
        _conf = Conf(ini_path)
        return _conf
