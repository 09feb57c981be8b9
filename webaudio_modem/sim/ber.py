"""BER evaluation harness (BASELINE config 2).

Measures decoded byte/bit error rates of a demodulator over an AWGN
channel at given SNRs, batched on device, with the golden scalar model
(golden/fsk_golden.py) as the reference comparator — BASELINE.md defines
BER parity as matching "the reference algorithm's BER curve, obtained by
running the bit-exact re-implementation".

The error metric is frame-oriented, matching how the reference's tests
judge decoding (exact byte match, tests/modems/fsk-demodulation.node.
test.ts:81-106): for each message, bit errors = hamming(decoded, sent)
counted over min-length + 8 bits per missing/extra byte.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from webaudio_modem.models.config import FSKConfig, FSKParams
from webaudio_modem.models.farm import ModemFarm
from webaudio_modem.ops import fsk_mod
from webaudio_modem.sim.channels import awgn_snr

_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                          axis=1).sum(1)


def bit_errors(sent: bytes, decoded: bytes) -> int:
    n = min(len(sent), len(decoded))
    errors = 8 * (max(len(sent), len(decoded)) - n)
    if n:
        a = np.frombuffer(sent[:n], dtype=np.uint8)
        b = np.frombuffer(decoded[:n], dtype=np.uint8)
        errors += int(_POPCOUNT[a ^ b].sum())
    return errors


@dataclasses.dataclass
class BERPoint:
    snr_db: float
    messages: int
    byte_errors: int
    bit_errors: int
    total_bits: int

    @property
    def ber(self) -> float:
        return self.bit_errors / max(self.total_bits, 1)

    @property
    def fer(self) -> float:
        """Frame error rate: fraction of messages not decoded exactly."""
        return self.byte_errors / max(self.messages, 1)


def ber_sweep(config: FSKConfig, snrs_db: Sequence[float],
              message: bytes = b"\x55\x0f\xa3\xc1",
              messages_per_point: int = 32,
              seed: int = 0,
              demodulate: Optional[Callable[[np.ndarray], List[bytes]]]
              = None) -> List[BERPoint]:
    """Run a BER-vs-SNR sweep.

    ``demodulate``: [B, T] noisy signals -> list of decoded bytes; the
    default uses the batched device ModemFarm.  Pass a wrapper over the
    golden model to produce the comparator curve on identical noise
    (same seed => identical noisy signals).
    """
    params = FSKParams.from_config(config)
    clean = np.asarray(fsk_mod.modulate(params, message))
    results = []
    for snr in snrs_db:
        rng = np.random.RandomState(seed + int(snr * 1000) % 99991)
        batch = np.stack([
            awgn_snr(clean, snr, rng) for _ in range(messages_per_point)])
        if demodulate is None:
            farm = ModemFarm(config, messages_per_point, donate=False)
            decoded = farm.demodulate(batch)
        else:
            decoded = demodulate(batch)
        byte_err = sum(1 for d in decoded if d != message)
        bits = sum(bit_errors(message, d) for d in decoded)
        results.append(BERPoint(
            snr_db=snr, messages=messages_per_point,
            byte_errors=byte_err, bit_errors=bits,
            total_bits=8 * len(message) * messages_per_point))
    return results


def golden_demodulate(config: FSKConfig) -> Callable[[np.ndarray],
                                                     List[bytes]]:
    """Comparator: decode each signal with a fresh golden scalar model."""
    from webaudio_modem.golden import GoldenFSK

    def run(batch: np.ndarray) -> List[bytes]:
        out = []
        for row in batch:
            g = GoldenFSK(config)
            out.append(g.demodulate(row))
        return out

    return run


def ber_parity_report(config: FSKConfig, snrs_db: Sequence[float],
                      **kwargs) -> Dict[str, List[BERPoint]]:
    """Device curve vs golden comparator curve on identical noise."""
    device = ber_sweep(config, snrs_db, **kwargs)
    golden = ber_sweep(config, snrs_db,
                       demodulate=golden_demodulate(config), **kwargs)
    return {"device": device, "golden": golden}
