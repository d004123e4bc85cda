"""Background-thread input prefetching (double buffering).

A copy of the JAX package's ``utils/prefetch.py`` (threads only), kept
here so the port imports nothing of that package. The reference
parallelizes its data generator with worker processes
(GeneratorEnqueuer/OrderedEnqueuer, keras_train.py:133-150); here a small
bounded-queue prefetcher runs vectorization of the next batches on a host
thread while the device is busy with the current step.
"""

import queue
import threading
import time

_SENTINEL = object()


class Prefetcher:
    """Wrap an iterator; a daemon thread keeps up to `depth` items ready.

    Call `close()` (or use as a context manager) when abandoning the
    iterator early — otherwise the worker stays blocked on the bounded
    queue, pinning the generator and anything it holds open."""

    def __init__(self, iterator, depth=2):
        self._queue = queue.Queue(maxsize=depth)
        self._err = None
        self._closed = False

        def worker():
            try:
                for item in iterator:
                    if self._closed:
                        return
                    self._queue.put(item)
                    if self._closed:
                        return
            except BaseException as err:  # propagate into the consumer
                self._err = err
            finally:
                self._queue.put(_SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if getattr(self, '_done', False):
            # iterator protocol: keep raising after exhaustion (the
            # worker is gone, a blocking get() would never return)
            raise StopIteration
        item = self._queue.get()
        if item is _SENTINEL:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self, timeout=5.0):
        """Release the worker thread after an early consumer exit.

        Bounded: if the worker is stuck *producing* (e.g. a wedged
        device transfer inside the wrapped generator), the daemon
        thread is abandoned after `timeout` rather than hanging the
        caller's shutdown path."""
        if getattr(self, '_done', False):
            return  # iteration already finished; sentinel consumed
        self._closed = True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive():
                    break
                continue
            if item is _SENTINEL:
                break
        self._done = True
        self._thread.join(timeout=max(0.0, deadline - time.monotonic()))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def prefetch(iterator, depth=2):
    return Prefetcher(iterator, depth=depth)
