"""Background-thread prefetching with device placement.

Counterpart of ``vit_ocm_wmsegmentation_tpu/data/prefetch.py``: a producer
thread runs the host work (decode, resize) and, through a ``place``
callable the caller passes, starts the host-to-device copy, so the device
never waits on image IO. On CUDA the callable should copy on a side stream
of its own and hand the consumer an event to wait on (sw_processing.py
does).
"""

from __future__ import annotations

import queue
import threading


class PrefetchIterator:
    """Wraps an iterator; a daemon thread keeps up to ``depth`` items ready,
    each passed through ``place`` (when given) on that thread.

    A consumer that abandons iteration early (break, exception) must not
    leave the producer blocked on the bounded queue holding device buffers
    for the life of the process: close() (also called on garbage collection
    and at StopIteration) sets a stop flag and drains the queue, so the
    producer's next put returns and the thread exits. An exception in the
    producer is raised on the consumer's side, after the items before it."""

    _DONE = object()

    def __init__(self, iterator, depth: int = 2, place=None):
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()

        def put(item):
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    return
                except queue.Full:
                    continue

        def produce():
            try:
                for item in iterator:
                    if self._stop.is_set():
                        return
                    put(place(item) if place is not None else item)
            except BaseException as e:  # noqa: BLE001  raised again by __next__
                self._err = e
            finally:
                # the sentinel must reach a live consumer even when the queue
                # is full at exhaustion; give up only once close() has marked
                # the consumer gone
                put(self._DONE)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def close(self):
        """Release the producer thread and the items it queued."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __del__(self):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration  # never block on a queue nobody fills
        item = self._q.get()
        if item is self._DONE:
            self._stop.set()
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item


def prefetch(iterator, depth: int = 2, place=None):
    """prefetch(items) -> an iterator over the same items, their host work
    (and ``place``) done ahead on a background thread."""
    return PrefetchIterator(iterator, depth, place)
