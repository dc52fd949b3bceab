"""DevicePrefetcher: host batches assembled ahead of the step loop.

The port of ``mmlspark_tpu/data/prefetch.py``. A background thread pulls
host batches (the host work: shuffling, tail padding, feature assembly)
and queues them ``depth`` deep (``runtime.prefetch_depth``). The consuming
``next()`` hands each one to the injected ``put`` on the caller's thread
and returns at once: the trainer's ``put_batch`` stages it in pinned host
memory and copies it with ``non_blocking=True``, so the copy overlaps the
step still running on the card. Exceptions in the producer re-raise at
the consuming ``next()``. Nothing here touches a device itself.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

from mmlspark_tpu_torch.observability import metrics as obsmetrics
from mmlspark_tpu_torch.reliability import watchdog as _watchdog
from mmlspark_tpu_torch.utils import config as mmlconfig


class DevicePrefetcher:
    """Double-buffered host->device prefetch over ``host_batches``."""

    _SENTINEL = object()

    def __init__(self, host_batches: Iterable[Dict[str, Any]],
                 put: Callable[[Dict[str, Any]], Any],
                 depth: Optional[int] = None):
        self.depth = depth if depth is not None else int(
            mmlconfig.get("runtime.prefetch_depth"))
        self._put = put
        self._q: queue.Queue = queue.Queue(maxsize=max(self.depth, 1))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._done = False
        self._closed = False
        self._telemetry = obsmetrics.metrics_enabled()

        def run():
            # beats on every produced batch and on every bounded wait: a
            # producer parked on a full queue is healthy back-pressure
            beat = _watchdog.register("data.prefetch")
            try:
                for hb in host_batches:
                    beat.beat()
                    if self._stop.is_set():
                        return
                    while not self._stop.is_set():
                        try:
                            self._q.put(hb, timeout=0.1)
                            break
                        except queue.Full:
                            beat.beat()
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                beat.close()
                while not self._stop.is_set():
                    try:
                        self._q.put(self._SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="mmlspark-tpu-torch-prefetch")
        self._thread.start()

    def close(self) -> None:
        """Stop the producer and drop queued host batches. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        # join first: draining before the join could free a slot the
        # producer refills at once
        self._thread.join(timeout=5)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._done = True

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._done:
            raise StopIteration
        item = self._q.get()
        if self._telemetry:
            obsmetrics.gauge("data.prefetch_queue_depth").set(self._q.qsize())
        if item is self._SENTINEL:
            self._done = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return self._put(item)
