from webaudio_modem.models.config import (  # noqa: F401
    DEFAULT_FSK_CONFIG,
    FSKConfig,
    FSKParams,
)
from webaudio_modem.models.fsk import FSKCore  # noqa: F401
from webaudio_modem.models.soft_modem import SoftModemCore  # noqa: F401
from webaudio_modem.models.farm import ModemFarm  # noqa: F401
from webaudio_modem.models.psk import (  # noqa: F401
    DEFAULT_PSK_CONFIG,
    PSKConfig,
    PSKCore,
)
