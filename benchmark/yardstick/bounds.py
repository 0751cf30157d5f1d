"""Least times of the sample-loop (K1) and GRU-training (K5) kernels.

Frozen copies of `chip_smoke.py`'s `gru_step_macs`, `weight_bytes`,
`k1_bound_ms` and `k5_bound_ms` at commit d7e6271, rewritten on the
configuration's sizes instead of the program's kernel bundle, so that no
change to the program moves them. The bound of a launch is the larger of
its multiply-adds over the peak rate of their type and the bytes it has to
move over HBM bandwidth; it ignores these kernels' real limit, a chain of
dependent steps.
"""

from __future__ import annotations

from .peaks import HBM_BPS, PEAK

LPC_ORDER = 16
PCM_LEVELS = 256


def gru_step_macs(na: int, nb: int) -> int:
    """Multiply-adds of one GRU-A and GRU-B step of a stream (the composed
    embedding: GRU-A's input is three table rows, no product)."""
    return na * 3 * na + na * 3 * nb + nb * 3 * nb


def weight_bytes(na: int, nb: int, gru_type: str) -> int:
    """Bytes of the operands a sample-loop launch reads once: GRU-A's
    recurrent matrix, GRU-B's input and recurrent matrices in the GRU type
    (int8 keeps GRU-A's diagonal in float32), the three [256, 3Na]
    embedding tables, the DualFC and the biases in float32."""
    size = {"int8": 1, "bf16": 2, "f32": 4}[gru_type]
    mats = size * gru_step_macs(na, nb)
    diag = 4 * 3 * na if gru_type == "int8" else 0
    tables = 4 * 3 * PCM_LEVELS * 3 * na
    dual = 4 * (nb * PCM_LEVELS * 2 + 2 * PCM_LEVELS * 2)
    biases = 4 * (2 * 3 * na + 2 * 3 * nb)
    return mats + diag + tables + dual + biases


def k1_bound_ms(na: int, nb: int, gru_type: str, batch: int, n: int):
    """Least time of one free-running sample-loop launch of `n` steps at
    `batch` streams: (ms, "operations" or "bytes")."""
    dual_macs = nb * 2 * PCM_LEVELS
    steps = batch * n
    op_s = (2 * gru_step_macs(na, nb) * steps / PEAK[gru_type]
            + 2 * dual_macs * steps / PEAK["f32"])
    per_stream = 4 * (3 * na + 3 * nb + LPC_ORDER          # cond_a, cond_b, lpc
                      + 2 * (na + nb + LPC_ORDER + 1 + 1)  # state in and out
                      + n) + 2 * (4 * 8 + 4)               # rng, exc in/out
    byte_s = (weight_bytes(na, nb, gru_type) + batch * per_stream) / HBM_BPS
    return 1e3 * max(op_s, byte_s), ("operations" if op_s >= byte_s else "bytes")


def k5_bound_ms(n: int, b: int, t: int, backward: bool):
    """Least time of K5 over one layer of `n` units: bytes over HBM
    bandwidth (forward reads gate_in, h0 and Wr in bf16, writes hs and hT;
    backward reads gate_in, hs, dhs and both weight layouts, writes
    dgate_in, dWr, dbr, dh0) against the bf16 multiply-adds (one product a
    step forward, three backward). Returns (ms, "operations" or "bytes")."""
    rows = b * t
    if backward:
        byts = 4 * rows * (3 * n + n + n + 3 * n) + 2 * 2 * 3 * n * n \
            + 4 * (3 * n * n + 3 * n + 3 * b * n)
        ops = 3 * 2 * rows * 3 * n * n
    else:
        byts = 4 * rows * (3 * n + n) + 2 * 3 * n * n + 4 * (3 * n + 2 * b * n)
        ops = 2 * rows * 3 * n * n
    byte_s, op_s = byts / HBM_BPS, ops / PEAK["bf16"]
    return 1e3 * max(byte_s, op_s), ("operations" if op_s >= byte_s else "bytes")
