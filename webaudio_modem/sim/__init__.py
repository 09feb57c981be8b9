from webaudio_modem.sim.channels import (  # noqa: F401
    awgn,
    awgn_snr,
    make_awgn_channel,
    make_chain,
    make_dc_offset,
    make_device_awgn,
    make_dropout_channel,
    make_gain,
    signal_power,
)
