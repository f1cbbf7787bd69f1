"""A pytest plugin that gives every phase of every test a wall-clock limit.

The repository's root ``conftest.py`` registers ``TimeLimit(LIMIT)``.
Around each test's setup, call and teardown it arms a real-time timer
(``SIGALRM``) and disarms it after.  When the timer fires, the handler
dumps every thread's stack to standard error (which pytest captures into the
test's report) and fails the phase with ``pytest.fail``.  The process lives on and runs the next test, so
under ``pytest-xdist`` a hung test costs one failure, not a worker.

The signal interrupts sleeps and waits on subprocesses, sockets and locks at
once; a long native call (an XLA compile) is interrupted when it returns to
Python.  Signals reach only the main thread: pytest-xdist runs each worker's
tests there.
"""
import faulthandler
import signal
import sys

import pytest


class TimeLimit:
    def __init__(self, seconds):
        self.seconds = seconds
        self._phase = None

    def _expire(self, signum, frame):
        faulthandler.dump_traceback(file=sys.__stderr__, all_threads=True)
        pytest.fail(f"{self._phase} ran past the time limit of "
                    f"{self.seconds:g} s")

    def _limited(self, phase):
        self._phase = phase
        previous = signal.signal(signal.SIGALRM, self._expire)
        signal.setitimer(signal.ITIMER_REAL, self.seconds)
        try:
            return (yield)
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_setup(self, item):
        return (yield from self._limited("setup"))

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_call(self, item):
        return (yield from self._limited("call"))

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_teardown(self, item):
        return (yield from self._limited("teardown"))
