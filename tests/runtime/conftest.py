"""Shared ARQ-over-audio harness for the runtime integration suites.

One copy of the stack bring-up (demo.js initializeSystem analog) and
the drive/teardown protocol, parameterized on the modem-core factory —
used by both the hard-UART (test_integration.py) and soft-FEC
(test_soft_integration.py) end-to-end suites so the protocol cannot
drift between them.
"""

import asyncio

import pytest

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG
from webaudio_modem.runtime import AudioGraph, FSKProcessor
from webaudio_modem.transports.xmodem import XModemTransport


def make_arq_stack(channel_fn=None, core_factory=None,
                   timeout_ms=20000, max_retries=3, quantum=512):
    """(graph, sender, receiver): two processors on one loopback graph
    with XModem transports.  ``core_factory`` returns a fresh modem
    core per processor (None = the default FSKCore)."""
    def proc(name):
        if core_factory is None:
            p = FSKProcessor(name=name)
        else:
            p = FSKProcessor(name=name, core=core_factory())
        p.configure(DEFAULT_FSK_CONFIG)
        return p

    sender_proc, receiver_proc = proc("sender"), proc("receiver")
    graph = AudioGraph(quantum=quantum, channel_fn=channel_fn)
    graph.connect(sender_proc)
    graph.connect(receiver_proc)
    sender = XModemTransport(sender_proc)
    receiver = XModemTransport(receiver_proc)
    # generous timeouts: the graph runs as-fast-as-possible but CI can
    # be slow; audio time != wall time here
    sender.configure({"timeout_ms": timeout_ms,
                      "max_retries": max_retries})
    receiver.configure({"timeout_ms": timeout_ms,
                        "max_retries": max_retries})
    return graph, sender, receiver


async def arq_transfer(graph, sender, receiver, data, timeout=300):
    """Drive the graph while one send_data/receive_data pair runs."""
    drive = asyncio.ensure_future(graph.run())
    try:
        send_task = asyncio.ensure_future(sender.send_data(data))
        received = await asyncio.wait_for(receiver.receive_data(),
                                          timeout=timeout)
        await asyncio.wait_for(send_task, timeout=30)
        return received
    finally:
        graph.stop()
        await drive


@pytest.fixture
def arq_stack():
    return make_arq_stack


@pytest.fixture
def transfer():
    return arq_transfer
