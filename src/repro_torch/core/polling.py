"""Polling services (paper §4.2, §4.5).

The runtime invokes registered callbacks both *periodically* — a dedicated
management thread processes the list every ``interval`` seconds (Nanos6 uses
1 ms; we default to the same) — and *opportunistically*: worker threads serve
the list before letting their core become idle (§4.5).

A callback returns a truthy value when its purpose has been attained, which
automatically unregisters it; otherwise the runtime keeps calling it.  As in
the paper, callbacks are assumed not to support concurrent execution: each
service carries a lock and concurrent servers skip (rather than wait on) a
service that is already being polled.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

PollingService = Callable[[Any], bool]


class _Service:
    __slots__ = ("name", "fn", "data", "lock", "done")

    def __init__(self, name: str, fn: PollingService, data: Any) -> None:
        self.name = name
        self.fn = fn
        self.data = data
        self.lock = threading.Lock()
        self.done = False

    def matches(self, name: str, fn: PollingService, data: Any) -> bool:
        return self.name == name and self.fn is fn and self.data is data


class PollingRegistry:
    """Thread-safe registry of polling services with a periodic poller."""

    def __init__(self, interval: float = 0.001) -> None:
        self.interval = interval
        self._lock = threading.Lock()
        self._services: List[_Service] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- the paper's API (§4.2) ------------------------------------------
    def register_polling_service(self, service_name: str,
                                 service_function: PollingService,
                                 service_data: Any = None) -> None:
        with self._lock:
            self._services.append(
                _Service(service_name, service_function, service_data))

    def unregister_polling_service(self, service_name: str,
                                   service_function: PollingService,
                                   service_data: Any = None) -> None:
        """Disable a callback; returns once it is no longer being invoked.

        Removes exactly ONE registration (the oldest still active), so
        register×2 + unregister×1 leaves one live service — matching the
        register/unregister pairing of the paper's API.  The matching
        ``_Service`` is captured under the same registry-lock hold that
        marks it ``done``: a concurrent ``poll_once`` may ``_gc()`` the
        marked service off the list at any point afterwards, so a second
        list snapshot could miss it and return while its callback is
        still running.
        """
        target = None
        with self._lock:
            for s in self._services:
                if not s.done and s.matches(service_name, service_function,
                                            service_data):
                    s.done = True
                    target = s
                    break
        if target is not None:
            # Returning "once the callback has been disabled" (§4.2):
            # grab the captured service's lock so no in-flight invocation
            # remains — the reference outlives any concurrent _gc().
            with target.lock:
                pass
        self._gc()

    # -- invocation --------------------------------------------------------
    def poll_once(self) -> int:
        """Serve the list once (opportunistic path). Returns #invocations."""
        with self._lock:
            snapshot = list(self._services)
        served = 0
        for s in snapshot:
            if s.done:
                continue
            # Callbacks may not support concurrent execution (§4.5): skip if
            # somebody else is already inside this one.
            if not s.lock.acquire(blocking=False):
                continue
            try:
                if s.done:
                    continue
                served += 1
                if s.fn(s.data):
                    s.done = True
            finally:
                s.lock.release()
        self._gc()
        return served

    def _gc(self) -> None:
        with self._lock:
            self._services = [s for s in self._services if not s.done]

    @property
    def num_services(self) -> int:
        with self._lock:
            return len(self._services)

    # -- periodic poller thread (§4.5) ------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="repro-poller", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.poll_once()
