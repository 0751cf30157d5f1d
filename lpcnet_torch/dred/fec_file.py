""".fec packet file format (FEC feature payloads for PLC evaluation), a
copy of the JAX package's `dred/fec_file.py` (numpy only).

Binary layout (training_tf2/fec_packets.py:34-74 / fec_packets.c:33-76):
int16 header [version=1, header_size=14, num_packets, packet_size,
subframe_size, subframes_per_packet, num_features], then per packet an
int16 rate followed by float32 features stored time-flipped.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

VERSION = 1
HEADER_SIZE = 14


def write_fec_packets(path: str, packets: List[np.ndarray],
                      rates: Optional[List[int]] = None) -> None:
    """packets: list of [subframes, num_features] float arrays."""
    num_packets = len(packets)
    subframes, num_features = packets[0].shape[-2], packets[0].shape[-1]
    subframe_size = num_features * 4
    packet_size = subframe_size * subframes + 2
    with open(path, "wb") as f:
        f.write(struct.pack("<7h", VERSION, HEADER_SIZE, num_packets,
                            packet_size, subframe_size, subframes, num_features))
        for i, packet in enumerate(packets):
            rate = 0 if rates is None else int(rates[i])
            f.write(struct.pack("<h", rate))
            f.write(np.flip(np.asarray(packet, np.float32), axis=-2).tobytes())


def read_fec_packets(path: str) -> Tuple[List[np.ndarray], List[int]]:
    with open(path, "rb") as f:
        version, header_size, num_packets, packet_size, subframe_size, \
            subframes, num_features = struct.unpack("<7h", f.read(14))
        if version != VERSION:
            raise ValueError(f"unsupported .fec version {version}")
        packets, rates = [], []
        for _ in range(num_packets):
            (rate,) = struct.unpack("<h", f.read(2))
            rates.append(rate)
            feats = np.frombuffer(f.read(subframe_size * subframes),
                                  dtype=np.float32).reshape(subframes, num_features)
            packets.append(np.flip(feats, axis=-2).copy())
    return packets, rates
