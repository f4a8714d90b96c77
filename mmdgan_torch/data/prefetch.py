"""Feeding host batches to one device, the single-device counterpart of
``DataParallel.prefetch`` (``mmdgan_tpu/parallel/mesh.py:366``).

``background`` runs an iterator in a daemon thread a few items ahead.
``prefetch`` uses it to pin each host batch, then copies the batches to
the card ``non_blocking`` on a side stream, ``size`` ahead of the consumer;
the consumer's stream waits on each batch's copy event, so the copy of the
next batch overlaps the steps on this one.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Dict, Iterable, Iterator

import torch

_STOP = object()
_JOIN_SECONDS = 10.0   # a producer checks for the close every 0.5 s between items


def background(items: Iterable, size: int) -> Iterator:
    """Iterate ``items`` in a daemon thread, up to ``size`` items ahead.
    An error in the thread is raised in the consumer, never dropped: a
    producer that died silently would look like a clean end of data.
    Closing the iterator stops the thread and waits for it: a thread left
    inside a CUDA call (pinning a batch) while the process exits aborts
    it."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    closed = threading.Event()

    def put(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        err = None
        try:
            for item in items:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — forwarded to the consumer
            err = e
        put((_STOP, err))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _STOP:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        closed.set()   # release a producer blocked on a full queue
        if thread is not threading.current_thread():
            thread.join(timeout=_JOIN_SECONDS)


def _tensors(batch: Dict, fn) -> Dict:
    return {k: None if v is None else fn(torch.as_tensor(v)) for k, v in batch.items()}


def prefetch(data_iter: Iterable[Dict], device, size: int = 2) -> Iterator[Dict]:
    """The batches of ``data_iter`` (dicts of arrays or None) as tensors on
    ``device``, ``size`` ahead. On the CPU they are only converted."""
    dev = torch.device(device)
    if dev.type != "cuda":
        for batch in data_iter:
            yield _tensors(batch, lambda t: t)
        return
    pinned = background((_tensors(b, lambda t: t.pin_memory()) for b in data_iter), size)
    stream = torch.cuda.Stream(dev)
    ahead: collections.deque = collections.deque()

    def fill() -> None:
        while len(ahead) < size:
            host = next(pinned, None)
            if host is None:
                return
            with torch.cuda.stream(stream):
                batch = {k: None if v is None else v.to(dev, non_blocking=True)
                         for k, v in host.items()}
                done = torch.cuda.Event()
                done.record(stream)
            ahead.append((batch, done))

    try:
        fill()
        while ahead:
            batch, done = ahead.popleft()
            current = torch.cuda.current_stream(dev)
            current.wait_event(done)
            for t in batch.values():
                if t is not None:
                    t.record_stream(current)
            fill()
            yield batch
    finally:
        pinned.close()
