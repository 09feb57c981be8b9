"""ctypes facade for the native CRC-16; raises ImportError when the
shared library is unavailable so utils.crc16 falls back to Python."""

from __future__ import annotations

from webaudio_modem.native import get_lib

_lib = get_lib()
if _lib is None:  # triggers the pure-Python fallback in utils.crc16
    raise ImportError("libmodem_native.so not available")


def calculate(data: bytes) -> int:
    return int(_lib.wam_crc16(data, len(data)))
