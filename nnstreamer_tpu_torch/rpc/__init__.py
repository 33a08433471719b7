"""IDL + transport layer for tensor streams over gRPC/protobuf/flatbuf.

Reference counterpart: ext/nnstreamer/extra/nnstreamer_grpc_*.cc
(NNStreamerRPC server/client over the protobuf and flatbuf IDLs in
ext/nnstreamer/include/nnstreamer.proto/.fbs) and the protobuf/flatbuf
converter+decoder subplugins. Redesigned for this framework: the message
schema is built at runtime from descriptor_pb2 (no codegen step), carries
bfloat16, and the gRPC service uses generic method handlers.

Codecs import lazily so the flatbuf path works without google.protobuf and
vice versa, and ``import nnstreamer_tpu_torch`` works with neither (nor
``grpc``) installed. A copy of the JAX package's ``rpc``: the encoders take
this package's ``Buffer``, whose tensors may be torch tensors on the card,
and bring them to the host first, so a frame encodes to the bytes the JAX
package gives its numpy twin. :func:`codec` and :func:`require` name the
missing package in an ``ElementError`` when an element or subplugin that
needs one starts without it; nothing falls back to another transport.
"""

import importlib

_LAZY = {
    "frame_from_bytes": "nnstreamer_tpu_torch.rpc.proto",
    "frame_to_bytes": "nnstreamer_tpu_torch.rpc.proto",
    "TensorFrameMsg": "nnstreamer_tpu_torch.rpc.proto",
    "frame_from_flex": "nnstreamer_tpu_torch.rpc.flat",
    "frame_to_flex": "nnstreamer_tpu_torch.rpc.flat",
}

#: the installable package behind each module this layer imports lazily
PACKAGES = {"grpc": "grpcio", "google.protobuf": "protobuf",
            "flatbuffers": "flatbuffers"}


def require(module: str, element: str):
    """Import ``module`` (a key of :data:`PACKAGES`) for ``element``, or
    raise ``ElementError`` naming the package it needs."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        from nnstreamer_tpu_torch.log import ElementError

        raise ElementError(
            element, f"needs the {PACKAGES[module]} package ({module}), "
                     f"which is not installed: {e}") from e


def codec(idl: str, element: str):
    """``(encode, decode)`` of a frame in ``idl`` (``protobuf`` or
    ``flatbuf``) for ``element``; raises as :func:`require` does."""
    if idl == "flatbuf":
        require("flatbuffers", element)
        from nnstreamer_tpu_torch.rpc.flat import frame_from_flex, frame_to_flex

        return frame_to_flex, frame_from_flex
    require("google.protobuf", element)
    from nnstreamer_tpu_torch.rpc.proto import frame_from_bytes, frame_to_bytes

    return frame_to_bytes, frame_from_bytes


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    return getattr(importlib.import_module(mod), name)
