"""The 1.6 kb/s codec in lpcnet_torch on the CPU: packets, quantizers,
decoded features, the encoder against the C fixture (bit-exact packets) and
the JAX package, packet decode through LPCNetDecoder and StreamPool against
the JAX package's decoder, and the CLI's encode -> decode round trip."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu import api as japi
from lpcnet_tpu.codec import codebooks as JCB
from lpcnet_tpu.codec import decoder as JD
from lpcnet_tpu.codec import encoder as JE
from lpcnet_tpu.codec import features as JF
from lpcnet_tpu.codec import packet as JP
from lpcnet_tpu.codec import quantize as JQ

from lpcnet_torch import api, cli
from lpcnet_torch.codec import codebooks as CB
from lpcnet_torch.codec import decoder as D
from lpcnet_torch.codec import encoder as E
from lpcnet_torch.codec import features as F
from lpcnet_torch.codec import packet as P
from lpcnet_torch.codec import quantize as Q
from lpcnet_torch.runtime.serving import StreamPool

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DEMO = str(ROOT / "lpcnet_tpu" / "data" / "demo_model.npz")
FIX = np.load(ROOT / "tests" / "fixtures" / "codec.npz")


def _superframes(pcm, n):
    return [pcm[..., t * 640:(t + 1) * 640] for t in range(n)]


def _streams(b, n_sf):
    """b streams of the fixture's speech, each rolled by its own offset."""
    pcm = FIX["pcm"].astype(np.float32)
    return np.stack([np.roll(pcm, -977 * i)[:n_sf * 640] for i in range(b)])


def test_packet_roundtrip_and_layout_match_jax():
    rs = np.random.RandomState(0)
    fields = {name: rs.randint(0, 1 << bits, size=(17,))
              for name, bits in P.FIELDS}
    pkts = P.pack_fields(fields)
    assert pkts.shape == (17, 8) and pkts.dtype == np.uint8
    assert np.array_equal(pkts, JP.pack_fields(fields))
    back = P.unpack_fields(pkts)
    for name, _ in P.FIELDS:
        assert back[name].dtype == np.int32
        assert np.array_equal(back[name], fields[name])
    # wider values are cut to their field's low bits, as the C bit writer
    wide = dict(fields, vq_mid=fields["vq_mid"] + (1 << 13))
    assert np.array_equal(P.pack_fields(wide), pkts)


def test_codebooks_load_and_save(tmp_path):
    cb = CB.load_codebooks()
    jcb = JCB.load_codebooks()
    for mine, theirs in zip(cb, jcb):
        assert np.array_equal(mine.numpy(), np.asarray(theirs))
    assert cb.diff4.shape == (4096, 18) and cb.stage1.shape == (1024, 17)
    path = str(tmp_path / "cb.npz")
    CB.save_codebooks(path, cb)
    assert all(torch.equal(a, b) for a, b in zip(CB.load_codebooks(path), cb))


def test_decoded_features_match_c_and_jax():
    """decode_packet_features on the fixture's 50 packets, vq_mem carried:
    within 1e-4 of the C decoder's features (the bar of
    test_codec_parity.py:41) and of the JAX package's; LPC columns zero."""
    pkts, want = FIX["packets"], FIX["decoded"]
    cbs, jcbs = CB.load_codebooks(), JCB.load_codebooks()
    vq, jvq = torch.zeros(1, 18), jnp.zeros((1, 18))
    jdecode = jax.jit(JD.decode_packet_features)
    for t in range(pkts.shape[0]):
        raw = P.unpack_fields(pkts[t][None])
        feats, vq = D.decode_packet_features(
            {k: torch.from_numpy(v) for k, v in raw.items()}, vq, cbs)
        jfeats, jvq = jdecode({k: jnp.asarray(v) for k, v in raw.items()},
                              jvq, jcbs)
        got = feats.numpy()[0]
        np.testing.assert_allclose(got, want[t], atol=1e-4, err_msg=str(t))
        np.testing.assert_allclose(got, np.asarray(jfeats)[0], atol=1e-5)
        assert not got[:, 20:].any()


def test_quantizers_match_jax_stream_by_stream():
    """The batched quantizers against the JAX package's single-stream ones,
    vmapped, on the fixture's features: equal indices and ids, values within
    1e-6."""
    rs = np.random.RandomState(1)
    f = FIX["features"].reshape(-1, 36)[:40, :18].astype(np.float32)
    b = 8
    x, left, right = (f[k * b:(k + 1) * b] for k in range(3))
    cbs, jcbs = CB.load_codebooks(), JCB.load_codebooks()
    t = torch.from_numpy
    idx, rec = Q.quantize_3stage_mbest(t(x[:, 1:]), cbs.stage1, cbs.stage2,
                                       cbs.stage3)
    jidx, jrec = jax.vmap(lambda v: JQ.quantize_3stage_mbest(
        v, jcbs.stage1, jcbs.stage2, jcbs.stage3))(x[:, 1:])
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), atol=1e-6)
    e, r = Q.quantize_diff(t(x), t(left), t(right), cbs.diff4)
    je, jr = jax.vmap(lambda a, l, r_: JQ.quantize_diff(a, l, r_, jcbs.diff4)
                      )(x, left, right)
    assert np.array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-6)
    f3 = f[24:32]
    ids = Q.double_interp_search(t(x), t(left), t(right), t(f3), t(x))
    jids = jax.vmap(JQ.double_interp_search)(x, left, right, f3, x)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    coded = t(rs.randint(0, 8, b).astype(np.int32))
    for mine, theirs in zip(
            Q.apply_double_interp(t(left), t(x), t(right), coded),
            jax.vmap(JQ.apply_double_interp)(left, x, right, coded.numpy())):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=0)
    periods = rs.uniform(40, 250, (b, 8)).astype(np.float32)
    w = rs.uniform(0.1, 1.0, (b, 8)).astype(np.float32)
    corr = rs.uniform(0.0, 0.9, b).astype(np.float32)
    pq = Q.quantize_pitch(t(periods), t(w), t(corr))
    jpq = jax.vmap(JQ.quantize_pitch)(periods, w, corr)
    for name in ("main_pitch", "modulation", "corr_id", "voiced"):
        assert np.array_equal(getattr(pq, name).numpy(),
                              np.asarray(getattr(jpq, name))), name
    for name in ("period_feat", "corr_feat"):
        np.testing.assert_allclose(getattr(pq, name).numpy(),
                                   np.asarray(getattr(jpq, name)), atol=1e-6)
    c0 = t(rs.normal(0, 20, b).astype(np.float32))
    for mine, theirs in zip(Q.quantize_c0(c0), JQ.quantize_c0(c0.numpy())):
        assert np.array_equal(mine.numpy(), np.asarray(theirs))


def test_encoder_packets_bit_exact_against_c():
    """LPCNetEncoder on the fixture's pcm: 50/50 packets bit-exact against
    the C encoder's (the bar of test_codec_parity.py:23)."""
    want = FIX["packets"]
    enc = E.LPCNetEncoder(batch=1, device="cpu")
    pcm = FIX["pcm"].astype(np.float32)
    got = np.stack([enc.encode(sf[None])[0]
                    for sf in _superframes(pcm, want.shape[0])])
    match = np.all(got == want, axis=1)
    assert match.all(), f"{match.sum()}/50 bit-exact; rows {np.where(~match)[0]}"


def test_batched_encoder_equals_one_stream_at_a_time():
    """Three streams in one batch give each stream's single-stream packets,
    and the JAX package's batched encoder's."""
    pcm = _streams(3, 6)
    enc = E.LPCNetEncoder(batch=3, device="cpu")
    jenc = JE.LPCNetEncoder(batch=3)
    got = np.stack([enc.encode(sf) for sf in _superframes(pcm, 6)], axis=1)
    jgot = np.stack([jenc.encode(sf) for sf in _superframes(pcm, 6)], axis=1)
    assert np.array_equal(got, jgot)
    for i in range(3):
        one = E.LPCNetEncoder(batch=1, device="cpu")
        alone = np.stack([one.encode(sf[None])[0]
                          for sf in _superframes(pcm[i], 6)])
        assert np.array_equal(got[i], alone), i


def test_compute_features_match_jax():
    """Unquantized superframe features against the JAX package's, 2 streams
    x 5 superframes: cepstrum within 1e-4, LPC within 1e-3 (the bar notes
    of ROADMAP.md queue 3: float32 Levinson on voiced speech amplifies the
    last bit), pitch
    period and correlation within 1e-4; the analysis state carried alike."""
    pcm = _streams(2, 5)
    st, feats = F.compute_features(F.init_encoder_state(2),
                                   torch.from_numpy(pcm))
    jst, jfeats = jax.jit(JF.compute_features)(JF.init_encoder_state(2),
                                               jnp.asarray(pcm))
    got, want = feats.numpy(), np.asarray(jfeats)
    assert got.shape == (2, 5, 4, 36)
    np.testing.assert_allclose(got[..., :18], want[..., :18], atol=1e-4)
    np.testing.assert_allclose(got[..., 18:20], want[..., 18:20], atol=1e-4)
    np.testing.assert_allclose(got[..., 20:], want[..., 20:], atol=1e-3)
    np.testing.assert_allclose(st.vq_mem.numpy(), np.asarray(jst.vq_mem),
                               atol=1e-4)
    # the excitation is the LPC residual: relative to its size, as LPC
    np.testing.assert_allclose(st.exc_buf.numpy(), np.asarray(jst.exc_buf),
                               rtol=1e-3, atol=1e-2)
    assert np.array_equal(st.viterbi.best_i.numpy(),
                          np.asarray(jst.viterbi.best_i))


def test_decoder_reproduces_the_encoder_quantized_cepstrum():
    """Encode -> pack -> unpack -> decode: the decoded cepstrum and pitch
    columns within 1e-5 of the encoder's quantized ones (the JAX round-trip
    bar, test_codec_parity.py:56-75), 2 streams x 4 superframes."""
    pcm = _streams(2, 4)
    cbs = CB.load_codebooks()
    st = F.init_encoder_state(2)
    vq = torch.zeros(2, 18)
    for sf in _superframes(pcm, 4):
        st, fq, fields = E.encode_superframe(st, torch.from_numpy(sf), cbs)
        pk = P.pack_fields({k: v.numpy() for k, v in fields.items()})
        raw = {k: torch.from_numpy(v) for k, v in P.unpack_fields(pk).items()}
        df, vq = D.decode_packet_features(raw, vq, cbs)
        np.testing.assert_allclose(df[..., :20].numpy(), fq[..., :20].numpy(),
                                   atol=1e-5)


def _pcm_stats(jp, tp, la):
    """(share of equal samples in the first live frame, warmup silent)."""
    frames = lambda p: p.reshape(p.shape[0], -1, 160)
    jf, tf = frames(jp), frames(tp)
    return (np.mean(jf[:, la] == tf[:, la]),
            not jf[:, :la].any() and not tf[:, :la].any())


def test_decoder_decode_matches_jax():
    """LPCNetDecoder.decode on the demo vocoder, 2 streams x 2 packets of
    the fixture, against the JAX package's decoder (scan path): the bars of
    test_torch_api.py::test_synthesizer_matches_jax (warmup frames silent,
    the first live frame >=98% equal, RNG in lockstep); vq_mem equal."""
    pk = np.stack([FIX["packets"][:2], FIX["packets"][7:9]])   # [2, 2, 8]
    fused, cfg = api.load_model(DEMO, device="cpu")
    dec = D.LPCNetDecoder.from_fused(fused, cfg, 2, with_codebooks=True,
                                     device="cpu")
    jfused, jcfg = japi.load_model(DEMO)
    jdec = JD.LPCNetDecoder(jfused, jcfg, batch=2, fused=True,
                            use_pallas=False)
    tp = np.concatenate([dec.decode(pk[:, t]) for t in range(2)], axis=1)
    jp = np.concatenate([jdec.decode(pk[:, t]) for t in range(2)], axis=1)
    assert tp.dtype == np.int16 and tp.shape == (2, 1280)
    same, silent = _pcm_stats(jp, tp, cfg.lookahead)
    assert silent and np.abs(tp).max() > 0
    assert same >= 0.98, same
    np.testing.assert_allclose(dec.vq_mem.numpy(), np.asarray(jdec.vq_mem),
                               atol=1e-6)
    for mine, theirs in zip(dec.sample_state.rng, jdec.sample_state.rng):
        assert np.array_equal(mine.numpy().astype(np.uint32),
                              np.asarray(theirs))


def test_decoder_reset_clears_vq_mem():
    fused, cfg = api.load_model(DEMO, device="cpu")
    dec = D.LPCNetDecoder.from_fused(fused, cfg, 1, with_codebooks=True,
                                     device="cpu")
    dec.decode(FIX["packets"][:1])
    assert dec.vq_mem.abs().max() > 0
    dec.reset()
    assert not dec.vq_mem.any() and not dec.frame_state.frame_count.any()
    synth_only = D.LPCNetDecoder.from_fused(fused, cfg, 1, device="cpu")
    with pytest.raises(ValueError):
        synth_only.decode(FIX["packets"][:1])


def _same_stream(got, want):
    """One stream's audio from a pool against a one-stream decoder's: every
    sample within 1 LSB and >=98% equal. The plain float32 path's products
    round differently at batch 4 than at batch 1 (CPU BLAS), which moves a
    rounded de-emphasised sample by one step now and then (measured: 0-1.9%
    of a frame's samples, never more than 1); the sampler stays in step."""
    diff = np.abs(got.astype(np.int32) - want)
    return diff.max() <= 1 and np.mean(diff == 0) >= 0.98


def test_stream_pool_packets_equal_bare_decoders_and_restart_cleanly():
    """StreamPool.step_packets on 3 streams in a pool of 4: each stream's
    audio is a one-stream decoder's on the same packets (`_same_stream`); a
    detached and re-attached stream starts again as a fresh decoder does
    (frame, sample and vq_mem state reset) while the others run on."""
    fused, cfg = api.load_model(DEMO, device="cpu")
    pk = FIX["packets"]
    offs = {"a": 0, "b": 11, "c": 23}
    pool = StreamPool(fused, cfg, capacity=4, device="cpu")
    ticks = 2
    outs = {sid: [] for sid in offs}
    for t in range(ticks):
        got = pool.step_packets({sid: pk[o + t] for sid, o in offs.items()})
        for sid in offs:
            outs[sid].append(got[sid])
    for sid, o in offs.items():
        bare = D.LPCNetDecoder.from_fused(fused, cfg, 1, with_codebooks=True,
                                          device="cpu")
        want = np.concatenate([bare.decode(pk[o + t][None])[0]
                               for t in range(ticks)])
        assert _same_stream(np.concatenate(outs[sid]), want), sid
    slot_b = pool.slot_of["b"]
    pool.detach("b")
    assert pool.n_active == 2
    got = pool.step_packets({"b": pk[40], "a": pk[2]})
    assert pool.slot_of["b"] == slot_b
    assert pool.dec.vq_mem[slot_b].abs().max() > 0
    fresh = D.LPCNetDecoder.from_fused(fused, cfg, 1, with_codebooks=True,
                                       device="cpu")
    assert _same_stream(got["b"], fresh.decode(pk[40][None])[0])
    assert not got["b"][:2 * 160].any()            # warmup again
    assert got["a"][:320].any()                    # "a" ran on


def test_stream_pool_features_tick():
    fused, cfg = api.load_model(DEMO, device="cpu")
    pool = StreamPool(fused, cfg, capacity=2, device="cpu")
    feats = FIX["features"].reshape(-1, 36)[:4]
    outs = [pool.step_features({"x": f[:20]}) for f in feats]
    s = api.Synthesizer(DEMO, batch=1, device="cpu")
    want = [s.synthesize(f[None, :20])[0] for f in feats]
    assert all(np.array_equal(o["x"], w) for o, w in zip(outs, want))


def test_api_codec_wrappers(tmp_path):
    pcm = FIX["pcm"][:3 * 640]
    enc = api.lpcnet_encoder_create(device="cpu")
    pkt = api.lpcnet_encode(enc, pcm[:640])
    assert pkt.shape == (8,) and np.array_equal(pkt, FIX["packets"][0])
    feats = api.lpcnet_compute_features(api.lpcnet_encoder_create(device="cpu"),
                                        pcm)
    assert feats.shape == (3, 4, 36)
    one = api.lpcnet_compute_single_frame_features(
        api.lpcnet_encoder_create(device="cpu"), pcm[:160])
    assert one.shape == (36,)
    dec = api.lpcnet_decoder_create(DEMO, device="cpu")
    out = api.lpcnet_decode(dec, pkt)
    assert out.shape == (640,) and out.dtype == np.int16
    lpc = api.add_lpc_to_features(FIX["decoded"][:2], device="cpu")
    want = japi.add_lpc_to_features(FIX["decoded"][:2])
    np.testing.assert_allclose(lpc, want, atol=1e-3)
    assert np.array_equal(lpc[..., :20], FIX["decoded"][:2, ..., :20])


def test_cli_encode_decode_roundtrip(tmp_path):
    """`cli encode` -> `cli decode` on the CPU: the packets are the C
    encoder's, the audio is the API decoder's on them; `features` and
    `addlpc` write their rows."""
    n = 3
    pin, bits, pout = (tmp_path / f for f in ("in.pcm", "x.lpcnet", "o.pcm"))
    FIX["pcm"][:n * 640].astype(np.int16).tofile(pin)
    cli.main(["encode", str(pin), str(bits), "--device", "cpu"])
    pk = np.fromfile(bits, np.uint8).reshape(-1, 8)
    assert np.array_equal(pk, FIX["packets"][:n])
    cli.main(["decode", str(bits), str(pout), "--device", "cpu"])
    got = np.fromfile(pout, np.int16)
    dec = api.lpcnet_decoder_create(DEMO, device="cpu")
    want = np.concatenate([api.lpcnet_decode(dec, p) for p in pk])
    assert got.shape == (n * 640,) and np.array_equal(got, want)
    assert not got[:320].any() and got[320:].any()
    ff, fl = tmp_path / "f.f32", tmp_path / "fl.f32"
    cli.main(["features", str(pin), str(ff), "--device", "cpu"])
    feats = np.fromfile(ff, np.float32).reshape(-1, 36)
    assert feats.shape == (n * 4, 36) and np.isfinite(feats).all()
    cli.main(["addlpc", str(ff), str(fl), "--device", "cpu"])
    assert np.fromfile(fl, np.float32).shape == (n * 4 * 36,)
