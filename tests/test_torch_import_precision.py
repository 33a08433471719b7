"""The TF32 scope of the imported graphs' ``custom=precision:``
(nnstreamer_tpu_torch/tools/_import_common.precision_scope) when invokes
run at once, as replicas, streams or two imported filters of one process
do. The flags it sets are process-wide; CPU torch stores them too, so a
``cuda`` device object is enough to drive the scope here, with no card.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)

from nnstreamer_tpu_torch.tools._import_common import (  # noqa: E402
    _TF32_GATE, precision_scope)

CUDA = torch.device("cuda")
#: the flags each precision asks for: (cudnn.allow_tf32, matmul.allow_tf32)
WANT = {"highest": (False, False), "default": (True, True)}


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def initial():
    saved = _flags()
    yield saved
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _thread(fn, *args):
    t = threading.Thread(target=fn, args=args, daemon=True)
    t.start()
    return t


def test_concurrent_invokes_each_see_their_own_precision(initial):
    """Two threads of each precision enter and leave the scope over and
    over, reading the flags on entry and again after a pause: every read
    is the thread's own precision, and the process's flags are as they
    were once all have left."""
    seen = []

    def invoke(precision):
        for _ in range(40):
            with precision_scope(precision, CUDA):
                a = _flags()
                time.sleep(0.0005)
                b = _flags()
            if a != WANT[precision] or b != WANT[precision]:
                seen.append((precision, a, b))

    ts = [_thread(invoke, p) for p in ("highest", "default") * 2]
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts)
    assert seen == []
    assert _flags() == initial


def test_other_precision_waits_for_the_live_invoke(initial):
    """A ``default`` invoke that arrives while a ``highest`` one is live
    waits for it to leave, and the flags stay the live invoke's."""
    a_in, a_go, b_in = threading.Event(), threading.Event(), threading.Event()
    b_saw = []

    def a():
        with precision_scope("highest", CUDA):
            a_in.set()
            a_go.wait(10)

    def b():
        with precision_scope("default", CUDA):
            b_in.set()
            b_saw.append(_flags())

    ta = _thread(a)
    assert a_in.wait(10)
    tb = _thread(b)
    assert not b_in.wait(0.2)
    assert _flags() == WANT["highest"]
    a_go.set()
    ta.join(10)
    tb.join(10)
    assert b_in.is_set() and b_saw == [WANT["default"]]
    assert _flags() == initial


def test_a_waiting_precision_is_not_starved(initial):
    """While a ``default`` invoke waits, a new ``highest`` one does not
    join the live ``highest`` invoke: the waiter goes first."""
    a_in, a_go = threading.Event(), threading.Event()
    order = []

    def a():
        with precision_scope("highest", CUDA):
            a_in.set()
            a_go.wait(10)

    def enter(name, precision):
        with precision_scope(precision, CUDA):
            order.append((name, _flags()))

    ta = _thread(a)
    assert a_in.wait(10)
    tb = _thread(enter, "b", "default")
    deadline = time.monotonic() + 10
    while not _TF32_GATE._waiting[True] and time.monotonic() < deadline:
        time.sleep(0.001)
    tc = _thread(enter, "c", "highest")
    time.sleep(0.2)
    assert order == []
    a_go.set()
    for t in (ta, tb, tc):
        t.join(10)
    assert order == [("b", WANT["default"]), ("c", WANT["highest"])]
    assert _flags() == initial


def test_nested_scope_passes_through(initial):
    """A scope nested in a thread that holds the gate keeps the flags; a
    nested scope of the other precision cannot be honoured and raises."""
    with precision_scope("highest", CUDA):
        with precision_scope("highest", CUDA):
            assert _flags() == WANT["highest"]
        assert _flags() == WANT["highest"]
        with pytest.raises(RuntimeError, match="nested"):
            with precision_scope(None, CUDA):
                pass
        assert _flags() == WANT["highest"]
    assert _flags() == initial


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_off_the_card_nothing_changes(initial, precision):
    with precision_scope(precision, torch.device("cpu")):
        assert _flags() == initial
    assert _flags() == initial
