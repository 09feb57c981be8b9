"""Observability: component-tagged logging, counters, and profiling.

SURVEY.md §5: the reference's tracing is component-tagged console logs
(`[XModemTransport]` xmodem.ts:106, `[FSKProcessor:name]`
fsk-processor.ts:78) plus debug counters surfaced through getStatus
(fsk.ts:481-493).  Here:

  * ``component_logger(name)`` — stdlib logger with the same bracketed
    component tags, switchable with ``set_debug``.
  * ``Metrics`` — process-wide counter/gauge/timer registry.  Wired
    call sites: FSKCore.demodulate_data (fsk.bytes_decoded / fsk.syncs
    / fsk.eods / fsk.demodulate_calls), ModemFarm.demodulate
    (farm.bytes_decoded + farm.chunk timer), XModemTransport
    (xmodem.packets_sent / packets_received / retransmits /
    rtt_ms_total / acks).  ``snapshot()`` dumps everything; the demos
    print it.
  * ``profile(path)`` — context manager around jax.profiler for device
    traces of the demod pipeline.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

_ROOT = "webaudio_modem"


def component_logger(component: str, instance: Optional[str] = None
                     ) -> logging.LoggerAdapter:
    name = f"{_ROOT}.{component}"
    tag = f"[{component}:{instance}]" if instance else f"[{component}]"
    return logging.LoggerAdapter(logging.getLogger(name), {"tag": tag})


def set_debug(enabled: bool = True) -> None:
    """Turn on the reference-style structured debug logging."""
    logger = logging.getLogger(_ROOT)
    if enabled and not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.DEBUG if enabled else logging.WARNING)


class Metrics:
    """Thread-safe counter/gauge/timer registry."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        # name -> [count, total_s, min_s, max_s] (bounded — a long-
        # running farm hub times two chunks per audio quantum forever)
        self._timings: Dict[str, list] = {}

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            with self._lock:
                agg = self._timings.get(name)
                if agg is None:
                    self._timings[name] = [1, dt, dt, dt]
                else:
                    agg[0] += 1
                    agg[1] += dt
                    agg[2] = min(agg[2], dt)
                    agg[3] = max(agg[3], dt)

    def snapshot(self) -> dict:
        with self._lock:
            timings = {
                k: {"count": v[0], "total_s": v[1],
                    "mean_ms": 1000 * v[1] / v[0],
                    "min_ms": 1000 * v[2], "max_ms": 1000 * v[3]}
                for k, v in self._timings.items()}
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "timings": timings}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timings.clear()


metrics = Metrics()  # process-wide default registry


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[None]:
    """Capture a device trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
