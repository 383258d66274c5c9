"""A deadline of its own for each port test that starts processes or
threads, and the tests of it.

``deadline(seconds)`` arms ``SIGALRM`` in the main thread: past the
deadline every thread's stack goes to stderr (``faulthandler``) and
:class:`DeadlineExceeded` is raised where the main thread waits, so a test
whose worker, prefetch thread or gang never answers fails on its own
instead of holding its xdist worker until the whole run's time limit cuts
it. Deadlines nest: an inner one gives back the outer's remaining time.
Off the main thread (where signals cannot be caught) it is a no-op.

Under xdist the same wrappers cap torch's intra-op threads at the host's
cores over the xdist workers (:func:`capped_threads`), as the port's cli
caps a gang's ranks: six workers each running an 8-thread OpenMP pool on 8
cores make a tiny model's CPU ops spin against preempted threads, and the
port's fit and evaluate tests then run 40-100× slower than alone (an
``evaluate`` of a tiny BERT: 0.45 s alone, 52 s in the tier-1 run; 12.7 s
beside 8 busy processes at 8 threads, 0.41 s at 1).

The port's test files import :func:`per_test` (the body of an autouse
fixture that puts each test under a deadline) and :func:`bounded` (for a
module-scoped fixture: its setup and its teardown under a deadline each)
from here.
"""

import contextlib
import faulthandler
import functools
import inspect
import os
import signal
import sys
import threading
import time

import pytest

#: the default deadline of one port test that starts processes or threads:
#: well past the slowest such test under the tier-1 run's six workers
#: (~80 s), far below the run's own limit
TEST_DEADLINE_S = 240.0
#: the deadline of a module-scoped fixture's setup (JAX and port runs, a
#: gang whose launcher has its own 300 s deadline)
FIXTURE_DEADLINE_S = 600.0


class DeadlineExceeded(Exception):
    """A test (or a fixture's setup) ran past its deadline."""


@contextlib.contextmanager
def deadline(seconds: float, what: str = "the test"):
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    start = time.monotonic()
    outer_left, _ = signal.getitimer(signal.ITIMER_REAL)

    def on_alarm(signum, frame):
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        raise DeadlineExceeded(f"{what} ran past its {seconds:g} s deadline "
                               f"(every thread's stack is on stderr)")

    previous = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        if outer_left:
            left = outer_left - (time.monotonic() - start)
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-3))


def thread_cap() -> int | None:
    """torch's intra-op threads for one xdist worker: the host's cores over
    the workers (None outside xdist)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers <= 1:
        return None
    return max(1, (os.cpu_count() or 1) // workers)


@contextlib.contextmanager
def capped_threads():
    """torch's intra-op threads at most :func:`thread_cap` inside, the
    previous count restored after."""
    cap = thread_cap()
    if cap is None:
        yield
        return
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(before, cap))
    try:
        yield
    finally:
        torch.set_num_threads(before)


def per_test(seconds: float = TEST_DEADLINE_S):
    """The body of an autouse fixture: each test of the file under
    :func:`deadline`, with torch's threads capped."""
    with capped_threads(), deadline(seconds):
        yield


def bounded(seconds: float = FIXTURE_DEADLINE_S):
    """Decorate a fixture function (under ``@pytest.fixture``): its setup
    and, for a generator fixture, its teardown run under :func:`deadline`,
    with torch's threads capped."""
    def wrap(fn):
        what = f"the {fn.__name__} fixture"
        if inspect.isgeneratorfunction(fn):
            @functools.wraps(fn)
            def gen(*args, **kwargs):
                it = fn(*args, **kwargs)
                with capped_threads(), deadline(seconds, what):
                    value = next(it)
                yield value
                with capped_threads(), deadline(seconds, what):
                    next(it, None)
            return gen

        @functools.wraps(fn)
        def plain(*args, **kwargs):
            with capped_threads(), deadline(seconds, what):
                return fn(*args, **kwargs)
        return plain
    return wrap


def test_deadline_fails_the_test_not_the_run():
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceeded, match="0.2 s deadline"):
        with deadline(0.2):
            threading.Event().wait(30)
    assert time.monotonic() - t0 < 5
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)


def test_deadlines_nest_and_restore_the_handler():
    before = signal.getsignal(signal.SIGALRM)
    with deadline(30, "outer"):
        with deadline(5, "inner"):
            time.sleep(0.01)
        left, _ = signal.getitimer(signal.ITIMER_REAL)
        assert 20 < left <= 30  # the outer's time, given back
        with pytest.raises(DeadlineExceeded, match="inner"):
            with deadline(0.1, "inner"):
                time.sleep(10)
        assert signal.getitimer(signal.ITIMER_REAL)[0] > 20
    assert signal.getsignal(signal.SIGALRM) is before
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)


def test_deadline_dumps_every_threads_stack(capfd):
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="stuck-helper", daemon=True)
    t.start()
    try:
        with pytest.raises(DeadlineExceeded):
            with deadline(0.1):
                time.sleep(10)
    finally:
        stop.set()
        t.join(5)
    err = capfd.readouterr().err
    assert "Current thread 0x" in err and "Thread 0x" in err
    assert "test_torch_deadline.py" in err


def test_deadline_off_the_main_thread_is_a_no_op():
    seen = []

    def body():
        with deadline(0.01):
            time.sleep(0.05)
        seen.append(signal.getitimer(signal.ITIMER_REAL))

    t = threading.Thread(target=body)
    t.start()
    t.join(5)
    assert seen == [(0.0, 0.0)]


@bounded(0.2)
def _stuck_setup():
    threading.Event().wait(30)
    yield


@bounded(5)
def _quick(x):
    yield x + 1
    _quick.torn_down = True


def test_bounded_fixture_setup_and_teardown():
    gen = _quick(1)
    assert next(gen) == 2 and next(gen, None) is None
    assert _quick.torn_down
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    assert list(inspect.signature(_quick).parameters) == ["x"]
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceeded, match="_stuck_setup fixture"):
        next(_stuck_setup())
    assert time.monotonic() - t0 < 5


def test_threads_capped_under_xdist_only(monkeypatch):
    import torch

    before = torch.get_num_threads()
    monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    assert thread_cap() is None
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", str(4 * (os.cpu_count() or 1)))
    assert thread_cap() == 1
    with capped_threads():
        assert torch.get_num_threads() == 1
    assert torch.get_num_threads() == before
