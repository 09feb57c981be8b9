"""Core contracts and base classes.

Batched analog of the reference's ``src/core.ts`` (interfaces
IAudioProcessor src/core.ts:34, IDataChannel :45, IModulator :88,
ITransport :131, TransportStatistics :180, EventEmitter :210,
BaseModulator :247, BaseTransport :299).

Differences from the reference by design:
  * async surfaces use asyncio + AbortSignal (utils.abort) instead of
    DOM AbortSignal,
  * modulate/demodulate exchange numpy arrays on the host boundary; the
    device-side compute is jitted JAX working on [B, T] batches.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

import numpy as np

from webaudio_modem.utils.abort import AbortSignal

# Reference src/core.ts:31 — WebAudio render quantum; retained as the
# minimum streaming granularity of the simulated audio graph.
AUDIO_CHUNK_SIZE = 128


@dataclasses.dataclass(frozen=True)
class SignalQuality:
    """Signal quality metrics (reference src/core.ts:10-16).

    The reference declares this surface but stubs it to zeros
    (src/core.ts:280-288, src/modems/fsk.ts:471-479); here it is
    genuinely computed by the demodulator (models/fsk.py).
    """

    snr: float = 0.0              # Signal-to-Noise Ratio (dB)
    ber: float = 0.0              # Bit Error Rate estimate
    eye_opening: float = 0.0      # Eye pattern opening (0-1)
    phase_jitter: float = 0.0     # Phase jitter (radians)
    frequency_offset: float = 0.0  # Frequency offset (Hz)


@dataclasses.dataclass
class TransportStatistics:
    """Transport statistics (reference src/core.ts:180-201)."""

    packets_sent: int = 0
    packets_received: int = 0
    packets_retransmitted: int = 0
    packets_dropped: int = 0
    bytes_transferred: int = 0
    error_rate: float = 0.0
    average_round_trip_time: float = 0.0

    def copy(self) -> "TransportStatistics":
        return dataclasses.replace(self)


class Event:
    """Minimal event object (reference src/core.ts:205-207)."""

    __slots__ = ("data",)

    def __init__(self, data: Any = None):
        self.data = data


class EventEmitter:
    """Synchronous pub/sub (reference src/core.ts:210-244)."""

    def __init__(self) -> None:
        self._listeners: Dict[str, List[Callable[[Event], None]]] = {}

    def on(self, event_name: str, callback: Callable[[Event], None]) -> None:
        self._listeners.setdefault(event_name, []).append(callback)

    def off(self, event_name: str, callback: Callable[[Event], None]) -> None:
        listeners = self._listeners.get(event_name)
        if listeners and callback in listeners:
            listeners.remove(callback)

    def emit(self, event_name: str, event: Optional[Event] = None) -> None:
        if event is None:
            event = Event()
        # Copy: a listener may mutate the list while we iterate.
        for callback in list(self._listeners.get(event_name, ())):
            callback(event)

    def remove_all_listeners(self, event_name: Optional[str] = None) -> None:
        if event_name is not None:
            self._listeners.pop(event_name, None)
        else:
            self._listeners.clear()


TConfig = TypeVar("TConfig")


class IModulator(EventEmitter, Generic[TConfig], metaclass=abc.ABCMeta):
    """Pure signal-processing engine contract (reference src/core.ts:88-117).

    ``demodulate_data`` is stream-stateful: it may be called with
    arbitrary chunk sizes and carries all DSP state across calls
    (reference src/core.ts:99-102), returning whatever bytes completed.
    """

    name: str = "modulator"

    def __init__(self) -> None:
        super().__init__()
        self._ready = False

    @abc.abstractmethod
    def configure(self, config: TConfig) -> None:
        ...

    @abc.abstractmethod
    def get_config(self) -> TConfig:
        ...

    @abc.abstractmethod
    def modulate_data(self, data: bytes | np.ndarray) -> np.ndarray:
        """data bytes -> float32 sample array."""

    @abc.abstractmethod
    def demodulate_data(self, samples: np.ndarray) -> bytes:
        """float32 samples -> decoded bytes (possibly empty)."""

    def reset(self) -> None:
        self._ready = False
        self.emit("reset")

    def is_ready(self) -> bool:
        return self._ready

    def get_signal_quality(self) -> SignalQuality:
        return SignalQuality()


class IDataChannel(metaclass=abc.ABCMeta):
    """Async data channel contract (reference src/core.ts:45-70).

    The transport layer talks ONLY to this interface — it never sees
    audio samples (reference src/core.ts:297-305).
    """

    @abc.abstractmethod
    async def modulate(self, data: bytes,
                       signal: Optional[AbortSignal] = None) -> None:
        """Modulate ``data`` into the outgoing audio stream; resolves
        once the signal has fully played out."""

    @abc.abstractmethod
    async def demodulate(self,
                         signal: Optional[AbortSignal] = None) -> bytes:
        """Return buffered demodulated bytes, waiting until at least one
        byte is available."""

    @abc.abstractmethod
    async def reset(self) -> None:
        ...


class IAudioProcessor(metaclass=abc.ABCMeta):
    """Realtime processor contract (reference src/core.ts:34-43).

    ``process`` is the analog of AudioWorkletProcessor.process: it is
    driven with fixed-size sample quanta by the simulated audio graph
    (runtime/audio_graph.py).
    """

    @abc.abstractmethod
    def process(self, inputs: np.ndarray, outputs: np.ndarray) -> bool:
        ...


class ITransport(EventEmitter, metaclass=abc.ABCMeta):
    """Reliable transport contract (reference src/core.ts:131-175)."""

    transport_name: str = "transport"

    def __init__(self, data_channel: IDataChannel) -> None:
        super().__init__()
        self.data_channel = data_channel
        self.statistics = TransportStatistics()

    @abc.abstractmethod
    async def send_data(self, data: bytes,
                        signal: Optional[AbortSignal] = None) -> None:
        ...

    @abc.abstractmethod
    async def receive_data(self,
                           signal: Optional[AbortSignal] = None) -> bytes:
        ...

    @abc.abstractmethod
    async def send_control(self, command: str) -> None:
        ...

    @abc.abstractmethod
    def is_ready(self) -> bool:
        ...

    def get_statistics(self) -> TransportStatistics:
        return self.statistics.copy()

    def reset(self) -> None:
        self.statistics = TransportStatistics()
        self.emit("reset")


# Aliases matching the reference naming for discoverability.
BaseModulator = IModulator
BaseTransport = ITransport
