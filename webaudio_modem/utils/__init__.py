from webaudio_modem.utils.abort import (  # noqa: F401
    AbortController,
    AbortError,
    AbortSignal,
)
from webaudio_modem.utils.crc16 import CRC16  # noqa: F401
from webaudio_modem.utils.ring_buffer import RingBuffer  # noqa: F401
