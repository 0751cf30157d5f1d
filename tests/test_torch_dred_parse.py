"""DRED's payload parse on the card (`kernels.dred_parse`), the parts a CPU
reaches: the host's checks before the launch, which refuse exactly the
payloads that the native parse (`runtime.dred_parse_payloads`) refuses and
name the same stream; the stage's layout (the starts, then the bytes) and
its growth; the probability table the kernel reads; and that a CPU device
takes no launch. The kernel's rows against the native call's are card
tests (`tests/test_torch_cuda.py -k dred_parse`)."""

import re

import numpy as np
import pytest
import torch

from lpcnet_torch.dred import entropy as EC
from lpcnet_torch.kernels import dred_parse as DX
from lpcnet_torch.models import rdovae as RV
from lpcnet_torch.runtime.bindings import runtime

torch.set_num_threads(1)

S, K, D = 24, 82, 80
V = RV.pvq_codebook_size(S, K)
NSB = (max(1, (V - 1).bit_length()) + 7) // 8
AT, LATER = 7, 20       # the stream at fault, and a later one at another fault


def _stats(seed=1, levels=16):
    rs = np.random.RandomState(seed)
    return {"p0_q15": rs.randint(1000, 32000, (levels, D)).astype(np.uint16),
            "r_q15": rs.randint(1000, 32000, (levels, D)).astype(np.uint16)}


def _sound(b, n_lat, seed, q_max=15):
    """b payloads of n_lat latents framed one by one (`encode_payload`),
    each at its own (q0, q1) up to q_max (q0 = q1 among them); streams 0
    and 1 carry the PVQ indices 0 and V(S, K) - 1."""
    rs = np.random.RandomState(seed)
    stats = _stats()
    out = []
    for i in range(b):
        q0, q1 = rs.randint(0, q_max + 1, 2)
        if i % 5 == 0:
            q1 = q0
        if i < 2:
            pulses = EC.pvq_decode_index(0 if i == 0 else V - 1, S, K)
        else:
            pulses = EC.pvq_search(rs.randn(S), K)
        zq = np.round(rs.laplace(0, 1.5, (n_lat, D))).astype(np.int64)
        out.append(EC.encode_payload(zq, pulses, int(q0), int(q1), stats, K))
    return out


def _fault(payload: bytes, case: str) -> bytes:
    if case == "short":
        return payload[:3 + NSB - 1]
    if case == "version":
        return bytes([0x20 | payload[0] & 0xF]) + payload[1:]
    if case == "latents":
        n = EC.payload_latent_count(payload) + 1
        return payload[:1] + bytes([payload[1] & 0xF0 | n >> 8, n & 0xFF]) + payload[3:]
    if case == "level":
        return bytes([payload[0] & 0xF0 | 15]) + payload[1:]
    assert case == "index"                  # exactly V(S, K): the first past the codebook
    return payload[:3] + V.to_bytes(NSB, "big") + payload[3 + NSB:]


def _native(batch, n_lat, stats):
    """The native parse's refusal: (stream, what) or None."""
    try:
        runtime.dred_parse_payloads(batch.data, batch.lengths, n_lat, D, S, K,
                                    stats["p0_q15"], stats["r_q15"])
    except ValueError as e:
        m = re.search(r"payload (\d+) is (.*)$", str(e))
        return int(m.group(1)), m.group(2)
    return None


def _card(batch, n_lat, stats):
    """The card's parse's refusal, from its host checks alone."""
    p = DX.Parsing(stats, len(batch), n_lat, D, S, K, "cpu")
    try:
        p.stage(batch)
    except ValueError as e:
        m = re.search(r"payload (\d+) is (.*)$", str(e))
        return int(m.group(1)), m.group(2)
    return None


@pytest.fixture(scope="module")
def sound():
    return _sound(40, 26, seed=3, q_max=11)


@pytest.mark.parametrize("case", ["sound", "short", "version", "latents", "level",
                                  "index"])
def test_host_checks_refuse_what_the_native_parse_refuses(sound, case):
    """A fault at stream 7, and another at stream 20: both parses refuse
    the batch and name stream 7 and its fault; a sound batch (indices 0
    and V - 1 among it, levels up to 11 of a 12-level table) passes both.
    The level fault is a q0 of 15 against the 12 levels."""
    stats = {name: t[:12] for name, t in _stats().items()}
    payloads = list(sound)
    if case != "sound":
        payloads[AT] = _fault(payloads[AT], case)
        payloads[LATER] = _fault(payloads[LATER], "version" if case == "short" else "short")
    batch = EC.Payloads.of(payloads)
    want = _native(batch, 26, stats)
    assert _card(batch, 26, stats) == want
    if case == "sound":
        assert want is None
    else:
        assert want is not None and want[0] == AT


@pytest.mark.parametrize("seed", range(4))
def test_host_checks_agree_with_the_native_parse_on_random_damage(seed):
    """64 payloads of 1 or 2 latents with random bytes of the header and
    the index's top two overwritten and random cuts, over 24 batches a
    seed: the same stream and fault, or none, from both."""
    rs = np.random.RandomState(100 + seed)
    n_lat = 1 + seed % 2
    base = _sound(64, n_lat, seed=seed, q_max=13)
    stats = _stats(levels=14)
    refused = set()
    for _ in range(24):
        payloads = [bytearray(p) for p in base]
        for i in rs.choice(64, rs.randint(0, 3), replace=False):
            at = rs.randint(0, 5)
            payloads[i][at] = rs.choice([0, 0xFF, payloads[i][at] ^ 1 << rs.randint(8),
                                         rs.randint(256)])
        if rs.rand() < 0.3:
            i = rs.randint(64)
            payloads[i] = payloads[i][:rs.randint(0, 3 + NSB + 1)]
        batch = EC.Payloads.of([bytes(p) for p in payloads])
        want = _native(batch, n_lat, stats)
        assert _card(batch, n_lat, stats) == want
        refused.add(None if want is None else want[1])
    assert len(refused) >= 3, refused


def test_stage_holds_the_starts_then_the_bytes_and_grows():
    """The stage: int64 starts [B + 1], then the payloads back to back;
    a larger batch of bytes grows it, a smaller one reuses it."""
    payloads = _sound(5, 2, seed=4)
    p = DX.Parsing(_stats(), 5, 2, D, S, K, "cpu")
    p.stage(EC.Payloads.of(payloads))
    host = p._host.numpy()
    starts = host[:48].view(np.int64)
    assert list(starts) == [0] + list(np.cumsum([len(x) for x in payloads]))
    assert host[48:48 + starts[-1]].tobytes() == b"".join(payloads)
    assert p._staged == 48 + starts[-1]
    first = p._host
    longer = [x + bytes(300) for x in payloads]
    p.stage(EC.Payloads.of(longer))
    assert p._host is not first and p._host.numel() >= 48 + sum(map(len, longer))
    grown = p._host
    p.stage(EC.Payloads.of(payloads))
    assert p._host is grown
    with pytest.raises(ValueError):
        p.stage(EC.Payloads.of(payloads[:4]))
    with pytest.raises(ValueError):
        p.upload()


def test_prob_table_clamps_as_the_native_parse():
    """p0 and 32768 - r, each clamped to [1, 32767], of at most 16 levels."""
    stats = {"p0_q15": np.array([[0, 1, 32767, 32768, 65535]] * 20, np.uint16),
             "r_q15": np.array([[65535, 0, 1, 32767, 32768]] * 20, np.uint16)}
    t = DX.prob_table(stats)
    assert t.dtype == torch.int16 and t.shape == (2, 16, 5)
    assert t[0, 0].tolist() == [1, 1, 32767, 32767, 32767]
    assert t[1, 0].tolist() == [1, 32767, 32767, 1, 1]


def test_parsing_reads_the_codebook_size_and_refuses_a_latent_count_off_range():
    p = DX.Parsing(_stats(), 3, 26, D, S, K, "cpu")
    assert p.nsb == NSB == 12 and p.rows.shape == (3, 26 * 81 + 24)
    assert int.from_bytes(bytes(p.v_max.astype(np.uint8)), "big") == V
    for n_lat in (0, 4096):
        with pytest.raises(ValueError):
            DX.Parsing(_stats(), 3, n_lat, D, S, K, "cpu")
