from webaudio_modem.runtime.chunked_modulator import (  # noqa: F401
    ChunkedModulator,
    ChunkResult,
)
from webaudio_modem.runtime.processor import FSKProcessor  # noqa: F401
from webaudio_modem.runtime.audio_graph import AudioGraph  # noqa: F401
from webaudio_modem.runtime.data_channel import (  # noqa: F401
    LoopbackDataChannel,
    QueueDataChannel,
)
from webaudio_modem.runtime.farm_channel import (  # noqa: F401
    FarmDataChannel,
    FarmLoopbackHub,
)
from webaudio_modem.runtime.device_hub import DeviceFarmHub  # noqa: F401
from webaudio_modem.runtime.soft_hub import (  # noqa: F401
    BlindSoftFarmHub, SoftFarmHub)
