from webaudio_modem.transports.xmodem import (  # noqa: F401
    ControlType,
    XModemConfig,
    XModemPacket,
    XModemTransport,
)
