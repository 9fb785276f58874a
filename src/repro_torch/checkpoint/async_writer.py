"""Asynchronous checkpoint persistence: overlap training with I/O (the twin
of ``src/repro/checkpoint/async_writer.py``).

``snapshot`` (device -> host copy) is synchronous and cheap; the durable
write happens on a background thread.  The next save (or an explicit
``wait``) barriers on the previous write — the standard async-checkpoint
contract (at most one in-flight write, training never blocked on disk).
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.checkpoint.reshard import save_global


class AsyncCheckpointer:
    def __init__(self, write_fn: Callable[[str, Dict[str, np.ndarray]], None]):
        """write_fn(name, leaves) performs the durable write."""
        self._write_fn = write_fn
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._inflight: Optional[Future] = None
        self._lock = threading.Lock()

    def save(self, name: str, state) -> Future:
        """Synchronously snapshot to host, asynchronously persist."""
        return self.save_leaves(name, save_global(state))

    def save_leaves(self, name: str, leaves: Dict[str, np.ndarray]) -> Future:
        """Persist an already-flattened snapshot (device->host done)."""
        with self._lock:
            if self._inflight is not None:
                self._inflight.result()      # one write in flight at a time
            self._inflight = self._pool.submit(self._write_fn, name, leaves)
            return self._inflight

    def wait(self) -> None:
        with self._lock:
            if self._inflight is not None:
                self._inflight.result()
                self._inflight = None

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
