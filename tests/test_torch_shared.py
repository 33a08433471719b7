"""What the port's test files share, imported by them: the thread pin
every file runs under, the element name counters emptied at each file's
end, and the JAX references that more than one file computes, each
computed once a process (``functools.lru_cache``).

The test run puts several workers on the machine's cores. A worker's
torch keeps one intra-op thread per core, and where all of them run
small CPU ops at once the pools stall in their barriers: a train step
that takes 2 s alone took 107 s so. So each port file runs with torch on
one intra-op thread and gets the worker's setting back at its end: a
file takes both fixtures by importing them,

    from test_torch_shared import equal_name_counters, one_torch_thread

and a test whose result was held at the worker's own count asks for
``worker_torch_threads``.

This module holds no tests of its own and imports no package of the
repo: a JAX reference is built inside the function that caches it.
"""

import functools
import sys

import pytest

torch = pytest.importorskip("torch")

#: the worker's own intra-op thread count, before any file pinned it
WORKER_THREADS = torch.get_num_threads()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for the importing file's tests, and
    the worker's own count again after them (threads that a pipeline
    starts read the same process-wide count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def equal_name_counters():
    """Each package names an unnamed element from its own counter
    (``queue7``). At the importing file's end both counters are emptied,
    as a fresh worker has them: a later file in the same worker looks
    elements up by those names (tests/test_controller.py looks for
    ``tensor_query_serversrc0``)."""
    yield
    for name in ("nnstreamer_tpu", "nnstreamer_tpu_torch"):
        element = sys.modules.get(f"{name}.pipeline.element")
        if element is not None:
            element.Element._name_counters.clear()


@pytest.fixture
def worker_torch_threads():
    """torch on the worker's own thread count for one test whose result
    was set at that count: a chaotic float32 train step's tolerance (the
    sums' order), or a measured ordering where a batch's product gains
    from the pool (a test asks for it by ``usefixtures``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(WORKER_THREADS)
    yield
    torch.set_num_threads(threads)


def jit_init(model, seed: int, dummy):
    """flax's init of ``model`` at ``PRNGKey(seed)`` on zeros shaped like
    ``dummy``, jitted (the same variables as the eager init, in a
    fraction of the time on the CPU), made once a process for each
    module, seed and input: the JAX zoo's ``_init_on_cpu`` in the files
    that build both packages' models from the same variables. Each call
    gets containers of its own around the same arrays, which are JAX's
    and cannot be written to."""
    import jax

    return jax.tree_util.tree_map(
        lambda a: a, _jit_init(model, int(seed), tuple(dummy.shape),
                               str(dummy.dtype)))


@functools.lru_cache(maxsize=None)
def _jit_init(model, seed, shape, dtype):
    import jax
    import jax.numpy as jnp

    return jax.jit(model.init)(jax.random.PRNGKey(seed),
                               jnp.zeros(shape, dtype))
