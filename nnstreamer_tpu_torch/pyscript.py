"""Shared loader for user Python-script subplugins (filters, converters,
decoders — the reference embeds CPython per subplugin type,
ext/nnstreamer/tensor_filter/tensor_filter_python3.cc and friends; here the
host is Python so loading reduces to one helper)."""

from __future__ import annotations

import importlib.util
import inspect
import os
from typing import Any, Dict, Optional, Type


def load_script_class(path: str, required_method: str) -> Type:
    """Load ``path`` and return the first class **in definition order** that
    defines ``required_method``. Raises ValueError when none qualifies."""
    spec = importlib.util.spec_from_file_location(
        f"nns_tpu_script_{os.path.basename(path).removesuffix('.py')}_{id(path)}",
        path,
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for obj in vars(mod).values():  # dict preserves definition order
        if (
            inspect.isclass(obj)
            and obj.__module__ == mod.__name__
            and callable(getattr(obj, required_method, None))
        ):
            return obj
    raise ValueError(f"{path}: no class with a {required_method}() method")


def instantiate_script_class(cls: Type, custom: Optional[Dict[str, str]] = None) -> Any:
    """Construct the user class, passing ``custom`` when its __init__ takes
    an argument (the reference forwards custom_properties likewise)."""
    if cls.__init__ is not object.__init__:
        try:
            sig = inspect.signature(cls.__init__)
            if len(sig.parameters) > 1:
                return cls(custom or {})
        except (TypeError, ValueError):
            pass
    return cls()
