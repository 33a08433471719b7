"""Developer tooling (counterpart of the JAX package's ``tools``): the
pipeline lint CLI, ``python -m nnstreamer_tpu_torch.tools.validate``.
"""
