"""custom-easy framework shim: ``tensor_filter framework=custom-easy
model=<registered-name>`` resolves models registered via
``register_custom_easy`` (tensor_filter_custom_easy.h:62 parity;
counterpart of the JAX package's ``filters/custom_easy.py``)."""

from __future__ import annotations

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.filters.base import FilterFramework, FilterProperties


class CustomEasyResolver(FilterFramework):
    """Opens the named in-process custom-easy model."""

    NAME = "custom-easy"

    def __init__(self):
        super().__init__()
        self._inner = None

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        name = props.model_file
        factory = registry.get(registry.CUSTOM_FILTER, name or "")
        if factory is None:
            raise ValueError(
                f"no custom-easy model {name!r} registered; "
                f"known: {registry.names(registry.CUSTOM_FILTER)}"
            )
        self._inner = factory() if callable(factory) else factory
        self._inner.open(props)

    def close(self) -> None:
        if self._inner is not None:
            self._inner.close()
            self._inner = None
        super().close()

    def get_model_info(self):
        return self._inner.get_model_info()

    def set_input_info(self, in_info):
        return self._inner.set_input_info(in_info)

    def invoke(self, inputs):
        return self._inner.invoke(inputs)

    # -- replica pool: delegate to the registered model's own declaration
    # (replica_safe=True at register_custom_easy)
    def replica_supported(self) -> bool:
        return self._inner is not None and self._inner.replica_supported()

    def build_replicas(self, n: int) -> bool:
        if self._inner is None:
            return n <= 1
        return self._inner.build_replicas(n)

    def replica_count(self) -> int:
        return self._inner.replica_count() if self._inner else 0

    def invoke_replica(self, replica: int, inputs):
        return self._inner.invoke_replica(replica, inputs)

    def replica_gate(self, replica: int):
        return (self._inner.replica_gate(replica)
                if self._inner is not None else self)


registry.register(registry.FILTER, "custom-easy")(CustomEasyResolver)
