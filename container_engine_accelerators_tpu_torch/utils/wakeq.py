"""WakeQueue: an unbounded FIFO whose timed get cannot lose a wakeup.

The port's copy of the JAX package's utils/wakeq.py, with the same
semantics. queue.SimpleQueue's timed get lives in the C _queue module,
whose wakeup can be lost when a put races the timed wait: the consumer
then sleeps the whole timeout (or forever with timeout=None) while an
item sits in the queue. The pure-Python queue.Queue has no such state
(its Condition uses monotonic deadlines), and the Event, set strictly
AFTER put, bounds any residual wait: a consumer parked on the Event is
woken by the very put it would otherwise have missed.

Consumers keep the call shape of `q.get(timeout=t)` (queue.Empty on
timeout); the device manager hands one to each health listener.
"""

from __future__ import annotations

import queue
import threading
import time


class WakeQueue:
    """Unbounded FIFO with lost-wakeup-proof timed gets.

    put() never blocks. get(timeout=) parks on the Event and drains
    non-blocking — no timed queue-get anywhere (see module docstring);
    a wake raced exactly at clear() costs one extra loop, never a
    missed item.
    """

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._work = threading.Event()

    def put(self, item) -> None:
        self._q.put(item)
        self._work.set()  # after put: a parked consumer must see it

    def empty(self) -> bool:
        return self._q.empty()

    def qsize(self) -> int:
        return self._q.qsize()

    def get_nowait(self):
        return self._q.get_nowait()

    def get(self, timeout: float | None = None):
        """Next item; raises queue.Empty once `timeout` elapses with
        nothing queued (timeout=None waits indefinitely)."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            try:
                return self._q.get_nowait()
            except queue.Empty:
                pass
            if deadline is None:
                self._work.wait()
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise queue.Empty
                self._work.wait(remaining)
            # Clear BEFORE the retry drain (the cli/serve.py ordering):
            # a put landing after this clear re-sets the event, so the
            # next wait returns immediately instead of losing the wake.
            self._work.clear()
