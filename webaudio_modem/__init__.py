"""webaudio_modem — an accelerator-batched software-modem framework.

A ground-up JAX/XLA/Pallas re-architecture of the capabilities of
cho45/WebAudio-Modem (reference: /root/reference): an FSK physical layer,
an XModem-like Stop-and-Wait ARQ transport, and a realtime streaming
runtime — designed array-first for an accelerator instead of per-sample
AudioWorklet callbacks.

Layer map (mirrors reference docs/architecture.md:19-59):

  core            contracts: IModulator / IDataChannel / ITransport, bases
  utils           CRC-16, ring buffer, events, abort signals
  ops             DSP ops: filter design, IIR/FIR kernels, demod pipeline
  ops.pallas      Triton kernels (Pallas) for the GPU hot paths
  models          modem cores (FSKCore) + batched channel-farm model
  golden          bit-exact scalar re-implementation of the reference
                  demodulator semantics (the BER-parity comparator)
  runtime         streaming harness: chunked modulator, processor,
                  data channels, simulated audio graph
  transports      data-link ARQ: XModem packets + state machine
  parallel        device mesh / sharding for the channel batch
  sim             channel simulators: AWGN, attenuation, DC, mixing
"""

__version__ = "0.3.0"

from webaudio_modem.core import (  # noqa: F401
    Event,
    EventEmitter,
    IDataChannel,
    IModulator,
    ITransport,
    SignalQuality,
    TransportStatistics,
)
