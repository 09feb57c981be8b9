from webaudio_modem.ops import filters  # noqa: F401
