"""Edge transport: the distribution layer's communication backend.

The reference leans on the external ``nnstreamer-edge`` library
(TCP / MQTT / hybrid pub-sub with discovery; SURVEY §2.5) consumed through
``nns_edge_*`` calls in tensor_query_*.c and edge_*.c. We own the
equivalent here: a length-framed TCP protocol carrying self-describing
(flexible-wrapped) tensors plus JSON metadata, server/client handles with
event callbacks (CAPABILITY / NEW_DATA_RECEIVED parity), and NTP-style
clock sync utilities.

A copy of the JAX package's ``edge/`` (protocol, handle, fleet, tracex,
ntp): the two packages put the same bytes on the wire, so a client of one
talks to a server of the other. Device tensors never touch this layer:
:func:`protocol.buffer_to_message` brings a frame's tensors to the host
first. This layer is the IP side: among-device pipeline offload
(tensor_query) and pub-sub streams (edgesrc/edgesink) over TCP. MQTT and
hybrid discovery are not part of this package yet.
"""

from nnstreamer_tpu_torch.edge.handle import EdgeClient, EdgeServer  # noqa: F401
from nnstreamer_tpu_torch.edge.protocol import (  # noqa: F401
    MSG_BYE,
    MSG_CAPABILITY,
    MSG_DATA,
    MSG_HELLO,
    MSG_RESULT,
    Message,
    recv_message,
    send_message,
)
