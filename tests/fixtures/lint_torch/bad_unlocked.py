"""Known-bad fixture: GL002 unlocked-shared-mutation (2 findings)."""
import threading


class ReplayPool:
    """Replays graphs from worker threads; its counters feed the autoscaler."""

    def __init__(self):
        self._lock = threading.Lock()
        self.replays = 0
        self.refused = 0
        self._worker = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while True:
            self.replays += 1  # BAD: no lock, threads interleave

    def refuse(self):
        self.refused += 1  # BAD: racing the worker thread

    def ok_locked(self):
        with self._lock:
            self.replays += 1  # fine: guarded
