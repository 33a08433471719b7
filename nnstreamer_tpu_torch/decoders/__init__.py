"""Decoder subplugins: other/tensors → media (labels, overlays, video...).

Mirrors GstTensorDecoderDef (nnstreamer_plugin_api_decoder.h:38-97):
init/exit/setOption/getOutCaps/decode, registered under registry type
'decoder' and dispatched by the tensor_decoder element
(gsttensor_decoder.c:741)."""

from nnstreamer_tpu_torch.decoders.base import Decoder, register_decoder  # noqa: F401
