"""Analysis helpers the slice's elements need: property schemas and
diagnostics (copied from the JAX package) and the lock factories.

The JAX package's static passes, lock witness and runtime sanitizer are
not part of this package yet; element code calls the plain factories in
:mod:`analysis.lockwitness`.
"""

from nnstreamer_tpu_torch.analysis.diagnostics import Diagnostic  # noqa: F401
from nnstreamer_tpu_torch.analysis.schema import Prop, schema_for  # noqa: F401
