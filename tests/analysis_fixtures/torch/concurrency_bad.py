"""Seeded thread-shared-state + lock-order violations around a torch
writer (exact lines asserted by the test)."""
import threading
from concurrent.futures import ThreadPoolExecutor


class SnapshotWriter:
    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._lock = threading.Lock()
        self.saved = 0
        self.leaves = {}

    def start(self, leaves):
        return self._pool.submit(self._write, leaves)

    def _write(self, leaves):
        self.saved += 1                    # line 18: thread-shared-state
        self.leaves = dict(leaves)         # line 19: thread-shared-state

    def reset(self):
        self.saved = 0                     # line 22: thread-shared-state
        return len(self.leaves)


class TierPair:
    def __init__(self):
        self.fast_lock = threading.Lock()
        self.slow_lock = threading.Lock()
        self.moved = 0

    def spill(self):
        with self.fast_lock:
            with self.slow_lock:           # line 34: lock-order (fast->slow)
                self.moved += 1

    def restore(self):
        with self.slow_lock:
            with self.fast_lock:           # line 39: lock-order (slow->fast)
                self.moved -= 1
