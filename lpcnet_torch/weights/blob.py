"""Reader/writer for the reference's binary weight container ("DNNw" blobs).

Format (src/nnet.h:41-61, src/parse_lpcnet_weights.c:36-77,
src/write_lpcnet_weights.c:47-67): a sequence of 64-byte headers each
followed by `block_size` (64-aligned) data bytes:

  struct WeightHead {
    char head[4] = "DNNw"; int version = 0; int type; int size;
    int block_size; char name[44];
  }

type: 0 = float32, 1 = int32, 2 = qweight (int8).

This module handles the container and the reference's two packed weight
encodings:

* block-sparse arrays (produced by training_tf2/dump_lpcnet.py:83-117):
  an `_idx` int stream [nb_blocks, row0, row1, ...] per 8-wide column
  stripe plus 4x8 weight blocks (int8 blocks transposed to 8x4); decoded
  here to dense [rows, cols] float plus an occupancy mask;
* "dotp" interleaved dense int8 (dump_lpcnet.py:55-59): rows/4 x 4 x cols/8
  x 8 transposed to (2,0,3,1).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

WEIGHT_BLOCK_SIZE = 64
HEAD_MAGIC = b"DNNw"
TYPE_FLOAT = 0
TYPE_INT = 1
TYPE_QWEIGHT = 2

_DTYPES = {TYPE_FLOAT: np.float32, TYPE_INT: np.int32, TYPE_QWEIGHT: np.int8}
_TYPE_OF = {np.dtype(np.float32): TYPE_FLOAT, np.dtype(np.int32): TYPE_INT,
            np.dtype(np.int8): TYPE_QWEIGHT}


def read_blob(data: bytes) -> Dict[str, np.ndarray]:
    """Parse a DNNw blob into {name: 1-D array} (dtype from the type field)."""
    arrays: Dict[str, np.ndarray] = {}
    off = 0
    n = len(data)
    while off < n:
        if n - off < WEIGHT_BLOCK_SIZE:
            raise ValueError("truncated weight header")
        head, version, typ, size, block_size = struct.unpack_from("<4siiii", data, off)
        name = data[off + 20: off + 64].split(b"\0", 1)[0].decode()
        if head != HEAD_MAGIC:
            raise ValueError(f"bad magic at offset {off}")
        if version != 0:
            raise ValueError(f"unsupported blob version {version}")
        if block_size < size or block_size > n - off - WEIGHT_BLOCK_SIZE:
            raise ValueError(f"bad block size for {name}")
        payload = data[off + WEIGHT_BLOCK_SIZE: off + WEIGHT_BLOCK_SIZE + size]
        arrays[name] = np.frombuffer(payload, dtype=_DTYPES[typ]).copy()
        off += WEIGHT_BLOCK_SIZE + block_size
    return arrays


def write_blob(arrays: Dict[str, np.ndarray]) -> bytes:
    """Serialize {name: array} into a DNNw blob (C-loadable)."""
    out = bytearray()
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        typ = _TYPE_OF[arr.dtype]
        raw = arr.tobytes()
        size = len(raw)
        block_size = (size + WEIGHT_BLOCK_SIZE - 1) // WEIGHT_BLOCK_SIZE * WEIGHT_BLOCK_SIZE
        nb = name.encode()
        if len(nb) > 43:
            raise ValueError(f"name too long: {name}")
        out += struct.pack("<4siiii", HEAD_MAGIC, 0, typ, size, block_size)
        out += nb + b"\0" * (44 - len(nb))
        out += raw + b"\0" * (block_size - size)
    return bytes(out)


# --------------------------------------------------------------------------
# Packed encodings
# --------------------------------------------------------------------------

def decode_sparse(weights: np.ndarray, idx: np.ndarray, rows: int, cols: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode the 8x4 block-sparse format to (dense [rows, cols], mask).

    `rows` is the input dimension (block row starts index it), `cols` the
    output dimension (consumed in stripes of 8).
    """
    dense = np.zeros((rows, cols), np.float32)
    mask = np.zeros((rows, cols), np.float32)
    qw = weights.dtype == np.int8
    pos = 0
    wpos = 0
    stripe = 0
    idx = idx.astype(np.int64)
    while pos < len(idx):
        nb_blocks = int(idx[pos]); pos += 1
        # validation mirrors find_idx_check (src/parse_lpcnet_weights.c:90-113)
        if nb_blocks < 0 or pos + nb_blocks > len(idx):
            raise ValueError("corrupt sparse index stream")
        for _ in range(nb_blocks):
            row = int(idx[pos]); pos += 1
            if row % 4 or row + 4 > rows:
                raise ValueError(f"bad sparse block row {row}")
            if wpos + 32 > len(weights):
                raise ValueError("sparse weight stream too short")
            block = weights[wpos: wpos + 32]
            wpos += 32
            if qw:
                # int8 blocks are stored transposed: [8 cols, 4 rows]
                b = block.reshape(8, 4).T.astype(np.float32) / 128.0
            else:
                b = block.reshape(4, 8).astype(np.float32)
            dense[row: row + 4, stripe * 8: stripe * 8 + 8] = b
            mask[row: row + 4, stripe * 8: stripe * 8 + 8] = 1.0
        stripe += 1
    if stripe * 8 != cols:
        raise ValueError(f"sparse idx covers {stripe * 8} cols, expected {cols}")
    return dense, mask


def encode_sparse(dense: np.ndarray, quantize: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a dense [rows, cols] matrix into the 8x4 block-sparse format.

    Blocks whose absolute sum is ~0 are dropped (training_tf2/
    dump_lpcnet.py:96-109). Returns (weights int8|float32, idx int32).
    """
    rows, cols = dense.shape
    assert rows % 4 == 0 and cols % 8 == 0
    q = np.clip(np.round(dense * 128.0), -128, 127).astype(np.int8)
    w_out: List[np.ndarray] = []
    idx_out: List[int] = []
    for stripe in range(cols // 8):
        pos = len(idx_out)
        idx_out.append(-1)
        nb = 0
        for rb in range(rows // 4):
            blk = dense[rb * 4:(rb + 1) * 4, stripe * 8:(stripe + 1) * 8]
            if np.sum(np.abs(blk)) > 1e-10:
                nb += 1
                idx_out.append(rb * 4)
                if quantize:
                    w_out.append(q[rb * 4:(rb + 1) * 4, stripe * 8:(stripe + 1) * 8].T.reshape(-1))
                else:
                    w_out.append(blk.reshape(-1).astype(np.float32))
        idx_out[pos] = nb
    w = (np.concatenate(w_out) if w_out else
         np.zeros((0,), np.int8 if quantize else np.float32))
    return w, np.asarray(idx_out, np.int32)


def decode_dotp_dense(flat: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Invert the dotp int8 interleave (dump_lpcnet.py:55-59)."""
    x = flat.reshape(cols // 8, rows // 4, 8, 4)
    x = x.transpose(1, 3, 0, 2).reshape(rows, cols)
    return x.astype(np.float32) / 128.0


def encode_dotp_dense(dense: np.ndarray) -> np.ndarray:
    rows, cols = dense.shape
    q = np.clip(np.round(dense * 128.0), -128, 127).astype(np.int8)
    return q.reshape(rows // 4, 4, cols // 8, 8).transpose(2, 0, 3, 1).reshape(-1)
