# Frozen copy of lpcnet_torch/codec/packet.py at commit d7e6271, kept to its plain
# paths. Part of the benchmark's yardstick: not to be edited.
"""64-bit packet pack/unpack for the 1.6 kb/s codec.

Field layout (MSB first within each byte, fields written in order), as
bits_pack / bits_unpack (src/lpcnet_enc.c:443-463, src/lpcnet_dec.c:59-107):

  c0_id+64 (7) | main_pitch (6) | modulation (3) | corr_id (2)
  | vq_end0 (10) | vq_end1 (10) | vq_end2 (10) | vq_mid (13) | interp (3)

Values wider than their field are cut to their low bits, as the reference's
bit writer does. NumPy uint64 arithmetic on the host: packets are an I/O
boundary (8 bytes per stream every 40 ms).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

FIELDS = (
    ("c0_id", 7),        # stored with +64 bias
    ("main_pitch", 6),
    ("modulation", 3),   # stored as modulation+4 when voiced, else 0
    ("corr_id", 2),
    ("vq_end0", 10),
    ("vq_end1", 10),
    ("vq_end2", 10),
    ("vq_mid", 13),
    ("interp", 3),
)
assert sum(b for _, b in FIELDS) == 64


def pack_fields(fields: Dict[str, np.ndarray]) -> np.ndarray:
    """Dict of [B] int arrays (raw wire values) -> [B, 8] uint8 packets."""
    b = np.broadcast(*fields.values()).shape or (1,)
    word = np.zeros(b, dtype=np.uint64)
    for name, bits in FIELDS:
        v = np.asarray(fields[name], dtype=np.int64) & ((1 << bits) - 1)
        word = (word << np.uint64(bits)) | v.astype(np.uint64)
    out = np.zeros(b + (8,), dtype=np.uint8)
    for i in range(8):
        out[..., i] = ((word >> np.uint64(8 * (7 - i)))
                       & np.uint64(0xFF)).astype(np.uint8)
    return out


def unpack_fields(packets: np.ndarray) -> Dict[str, np.ndarray]:
    """[..., 8] uint8 packets -> dict of [...] int32 raw wire values."""
    packets = np.asarray(packets, dtype=np.uint64)
    word = np.zeros(packets.shape[:-1], dtype=np.uint64)
    for i in range(8):
        word = (word << np.uint64(8)) | packets[..., i]
    out = {}
    pos = 64
    for name, bits in FIELDS:
        pos -= bits
        out[name] = ((word >> np.uint64(pos))
                     & np.uint64((1 << bits) - 1)).astype(np.int32)
    return out
