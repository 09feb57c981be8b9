from webaudio_modem.golden.fsk_golden import GoldenFSK  # noqa: F401
