"""XModem packet codec (reference src/transports/xmodem/packet.ts).

Byte-identical wire format: SOH | SEQ | ~SEQ | LEN | PAYLOAD | CRC16-BE,
CRC over the payload only (packet.ts:38).
"""

from __future__ import annotations

import dataclasses

from webaudio_modem.transports.xmodem.types import (ControlType,
                                                        PacketConstants)
from webaudio_modem.utils.crc16 import CRC16


@dataclasses.dataclass(frozen=True)
class DataPacket:
    soh: int
    sequence: int
    inv_sequence: int
    length: int
    payload: bytes
    checksum: int


class XModemPacket:
    @staticmethod
    def create_data(sequence: int, payload: bytes) -> DataPacket:
        if sequence < 1 or sequence > 255:
            raise ValueError(f"Invalid sequence: {sequence}. Must be 1-255.")
        if len(payload) > PacketConstants.MAX_PAYLOAD_SIZE:
            raise ValueError(
                f"Payload too large: {len(payload)}. Max 255 bytes.")
        payload = bytes(payload)
        return DataPacket(
            soh=PacketConstants.SOH,
            sequence=sequence,
            inv_sequence=(~sequence) & 0xFF,
            length=len(payload),
            payload=payload,
            checksum=CRC16.calculate(payload),
        )

    @staticmethod
    def serialize(packet: DataPacket) -> bytes:
        return bytes([
            packet.soh, packet.sequence, packet.inv_sequence, packet.length,
        ]) + packet.payload + bytes([
            (packet.checksum >> 8) & 0xFF, packet.checksum & 0xFF,
        ])

    @staticmethod
    def verify(packet: DataPacket) -> bool:
        return CRC16.calculate(packet.payload) == packet.checksum

    @staticmethod
    def serialize_control(control_type: ControlType) -> bytes:
        return bytes([control_type])
