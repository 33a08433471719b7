"""Custom-filter skeleton generator (counterpart of the JAX package's
``tools/codegen.py``).

Reference counterpart: tools/development/nnstreamerCodeGenCustomFilter.py
(emits C boilerplate for the custom-filter ABI). Targets here:
  - ``python`` — a filter script for ``tensor_filter framework=python3``;
  - ``jax`` — a model file for ``tensor_filter framework=jax
    model=<file>.py``, which this package serves through
    :func:`models.load_py_model` (a torch function, no JAX);
  - ``c`` — an nnstpu_custom_filter vtable .c (native/include/nnstpu/
    capi.h), buildable into a .so for ``framework=custom``.
The ``python`` and ``c`` templates are the JAX package's, byte for byte.

Usage: python -m nnstreamer_tpu_torch.tools.codegen python MyFilter > my_filter.py
"""

from __future__ import annotations

import sys

_PY_TEMPLATE = '''"""Custom filter: {name} (generated skeleton).

Run with: tensor_filter framework=python3 model={file}
"""

import numpy as np


class CustomFilter:
    def __init__(self, *args):
        # args: the element's custom= string, split on whitespace
        pass

    def getInputDim(self):
        # innermost-first dims + numpy dtypes, one per input tensor
        return [((4,), np.float32)]

    def getOutputDim(self):
        return [((4,), np.float32)]

    def invoke(self, input_arrays):
        # one frame: list of np.ndarray in, list of np.ndarray out
        return [np.asarray(input_arrays[0])]
'''

_JAX_TEMPLATE = '''"""Model file: {name} (generated skeleton).

Run with: tensor_filter framework=jax model={file}
"""

from nnstreamer_tpu_torch.types import TensorsInfo


def make_model(custom: dict):
    scale = float(custom.get("scale", 1.0))

    def apply_fn(params, x):
        return x * scale

    info = TensorsInfo.from_strings("4", "float32")
    return apply_fn, {{}}, info, info
'''

_C_TEMPLATE = '''/* Custom native filter: {name} (generated skeleton).
 *
 * Build: g++ -O2 -fPIC -shared -I<repo>/native/include {file} -o lib{name}.so
 * Register from the embedder via nnstpu_register_custom_filter, then use
 * tensor_filter framework={name} in a native pipeline.
 */
#include <string.h>

#include "nnstpu/capi.h"

static void *f_init(const char *props) {{ (void)props; return 0; }}
static void f_exit(void *priv) {{ (void)priv; }}

static int f_set_input_dim(void *priv, const nnstpu_tensors_info *in,
                           nnstpu_tensors_info *out) {{
  (void)priv;
  *out = *in; /* passthrough shape; edit for your model */
  return 0;
}}

static int f_invoke(void *priv, const nnstpu_tensor_mem *in, uint32_t n_in,
                    nnstpu_tensor_mem *out, uint32_t n_out) {{
  (void)priv;
  if (n_in != n_out) return -1;
  for (uint32_t i = 0; i < n_in; ++i) {{
    if (in[i].size != out[i].size) return -1;
    memcpy(out[i].data, in[i].data, in[i].size);
  }}
  return 0;
}}

/* canonical entry symbol: loadable by the native core (register via
 * nnstpu_register_custom_filter) AND by Python pipelines
 * (tensor_filter framework=custom model=lib{name}.so) */
extern const nnstpu_custom_filter nnstpu_filter_entry;
const nnstpu_custom_filter nnstpu_filter_entry = {{
  f_init, f_exit, 0, 0, f_set_input_dim, f_invoke,
}};
'''


def generate(kind: str, name: str) -> str:
    file = f"{name.lower()}.py" if kind in ("python", "jax") else f"{name.lower()}.c"
    if kind == "python":
        return _PY_TEMPLATE.format(name=name, file=file)
    if kind == "jax":
        return _JAX_TEMPLATE.format(name=name, file=file)
    if kind == "c":
        return _C_TEMPLATE.format(name=name.lower(), file=file)
    raise ValueError(f"unknown kind {kind!r}; want python|jax|c")


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 2:
        print("usage: codegen <python|jax|c> <FilterName>", file=sys.stderr)
        return 2
    print(generate(args[0], args[1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
