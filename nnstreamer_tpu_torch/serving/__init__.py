"""nnserve — the continuous-batching serving tier on tensor_query_server.

The reference's query family (tensor_query_serversrc/serversink) pops one
request at a time: every client's frame rides the pipeline alone, so
device batching, fairness, and overload behavior don't exist. This
package is the layer between the socket and the pipeline:

- :mod:`serving.scheduler` — :class:`ServingScheduler`: a request pool
  keyed by (caps signature, tenant) that assembles the next micro-batch
  from *all waiting clients* the moment the pipeline asks for a buffer
  (continuous batching — a client is never blocked on its own batch
  filling), pads to the configured batch so exactly ONE input signature
  reaches the filter, and carries per-row routing meta the serversink
  uses to demultiplex replies.
- :mod:`serving.admission` — token-bucket admission per tenant,
  bounded queue depth, and weighted-fair (stride) dequeue. Overload is
  shed with a ``SERVER_BUSY`` reply (on-error=drop semantics: shed,
  don't collapse) instead of letting queues grow without bound.
- :mod:`serving.controller` — nnctl, the SLO-driven closed-loop
  controller (``ctl=1 slo-ms=<N>``): samples the scheduler's live
  measurement window each tick and hot-sets serve-batch / linger /
  per-tenant rates while serving, with predictive shedding priced by
  the :mod:`analysis.plant` model (shed reason ``ctl_predicted_miss``).

Enabled per server via ``tensor_query_serversrc serve=1 serve-batch=N``
(off by default); observability lands on the pipeline tracer under
``serving``. A copy of the JAX package's serving tier over this
package's transport and buffers.
"""

from nnstreamer_tpu_torch.serving.admission import (  # noqa: F401
    AdmissionController,
    TokenBucket,
    parse_weights,
)
from nnstreamer_tpu_torch.serving.controller import (  # noqa: F401
    ReplayFeed,
    SchedulerFeed,
    ServingController,
    SimClock,
    parse_ctl_bounds,
)
from nnstreamer_tpu_torch.serving.scheduler import (  # noqa: F401
    PendingRequest,
    ServingScheduler,
)
