"""Converter subplugins — external media formats → other/tensors
(counterpart of the JAX package's ``converters/``).

Parity: NNStreamerExternalConverter (nnstreamer_plugin_api_converter.h:41-85)
and ext/nnstreamer/tensor_converter/{flexbuf,python3,flatbuf,protobuf};
the flatbuf and protobuf converters import the ``flatbuffers`` and
``google.protobuf`` packages only when a stream reaches them. A converter
subplugin is an object with:

    accepts(media_type: str) -> bool       # query_caps/is-supported parity
    get_out_config(caps) -> TensorsConfig  # get_out_caps parity
    convert(buf) -> Buffer                 # convert vtable entry

Self-registration under registry type CONVERTER (the .so constructor
register_subplugin parity). tensor_converter consults them for media types
its built-in video/audio/text/octet paths don't handle
(findExternalConverter gsttensor_converter.c:171).
"""

from __future__ import annotations

from nnstreamer_tpu_torch import registry


def register_converter(name: str):
    """Decorator parity for registerExternalConverter."""

    def deco(cls):
        registry.register(registry.CONVERTER, name)(cls)
        return cls

    return deco
