from webaudio_modem.parallel.sharding import (  # noqa: F401
    channel_sharding,
    make_mesh,
    shard_state,
)
