"""Built-in elements. Importing this package registers all element classes
(parity: the single plugin registerer, gst/nnstreamer/registerer/nnstreamer.c:53-75)."""

import nnstreamer_tpu_torch.elements.aggregator  # noqa: F401
import nnstreamer_tpu_torch.elements.basic  # noqa: F401
import nnstreamer_tpu_torch.elements.converter  # noqa: F401
import nnstreamer_tpu_torch.elements.decoder  # noqa: F401
import nnstreamer_tpu_torch.elements.edge_elems  # noqa: F401
import nnstreamer_tpu_torch.elements.filter  # noqa: F401
import nnstreamer_tpu_torch.elements.query  # noqa: F401
import nnstreamer_tpu_torch.elements.transform  # noqa: F401
