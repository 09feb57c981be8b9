from webaudio_modem.transports.xmodem.types import (  # noqa: F401
    ControlType,
    PacketConstants,
)
from webaudio_modem.transports.xmodem.packet import (  # noqa: F401
    DataPacket,
    XModemPacket,
)
from webaudio_modem.transports.xmodem.xmodem import (  # noqa: F401
    State,
    XModemConfig,
    XModemTransport,
)
