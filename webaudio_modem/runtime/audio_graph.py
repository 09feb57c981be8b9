"""Simulated audio graph — the loopback hub.

Replaces the reference demo's WebAudio render graph
(demo/demo.js:396-428: sender & receiver worklet nodes wired through a
GainNode hub, with every node hearing the mix) with an explicit
simulator: each ``step()`` pulls one quantum from every processor,
mixes them through an optional channel function (AWGN, attenuation,
filters — see sim/channels.py), and feeds the mix back to every
processor's input, exactly like the loopback GainNode topology.

``run()`` drives the graph as an asyncio task so transports awaiting
modulate/demodulate make progress while audio "plays".
"""

from __future__ import annotations

import asyncio
from typing import Callable, List, Optional

import numpy as np

from webaudio_modem.core import AUDIO_CHUNK_SIZE, IAudioProcessor

ChannelFn = Callable[[np.ndarray], np.ndarray]


class AudioGraph:
    def __init__(self, quantum: int = AUDIO_CHUNK_SIZE,
                 channel_fn: Optional[ChannelFn] = None,
                 gain: float = 1.0, sample_rate: int = 48000):
        self.quantum = quantum
        self.channel_fn = channel_fn
        self.gain = gain
        self.sample_rate = sample_rate
        self.processors: List[IAudioProcessor] = []
        self._next_inputs: List[np.ndarray] = []
        self._running = False
        self.steps = 0

    def connect(self, processor: IAudioProcessor) -> None:
        self.processors.append(processor)
        self._next_inputs.append(np.zeros(self.quantum, np.float32))

    def step(self) -> np.ndarray:
        """Render one quantum: outputs -> hub mix -> channel -> inputs.

        Returns the hub mix for observability (the analyser-node analog,
        demo/demo.js:224-227).
        """
        outputs = []
        for proc, inp in zip(self.processors, self._next_inputs):
            out = np.zeros(self.quantum, np.float32)
            proc.process(inp, out)
            outputs.append(out)
        mix = np.sum(outputs, axis=0, dtype=np.float32) * np.float32(self.gain)
        if self.channel_fn is not None:
            mix = np.asarray(self.channel_fn(mix), dtype=np.float32)
        self._next_inputs = [mix.copy() for _ in self.processors]
        self.steps += 1
        return mix

    async def run(self, max_steps: Optional[int] = None,
                  yield_every: int = 4, realtime: bool = False) -> None:
        """Drive the graph until stopped (or ``max_steps``), yielding to
        the event loop so protocol coroutines interleave.

        ``realtime=True`` paces rendering at the audio clock (the
        browser render-thread budget, core.ts:31): each quantum is
        released no earlier than its wall-clock deadline.
        """
        import time

        self._running = True
        n = 0
        start = time.monotonic()
        try:
            while self._running and (max_steps is None or n < max_steps):
                self.step()
                n += 1
                if realtime:
                    deadline = start + n * self.quantum / self.sample_rate
                    delay = deadline - time.monotonic()
                    await asyncio.sleep(max(delay, 0))
                elif n % yield_every == 0:
                    await asyncio.sleep(0)
        finally:
            self._running = False

    def stop(self) -> None:
        self._running = False
