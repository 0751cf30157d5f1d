"""Command-line codec and vocoder, as the reference's `lpcnet_demo`
(src/lpcnet_demo.c):

    python -m lpcnet_torch.cli encode    <input.pcm> <compressed.lpcnet>
    python -m lpcnet_torch.cli decode    <compressed.lpcnet> <output.pcm>
    python -m lpcnet_torch.cli features  <input.pcm> <features.f32>
    python -m lpcnet_torch.cli synthesis <features.f32> <output.pcm>
                                         [--sampling tree|pdf]
    python -m lpcnet_torch.cli addlpc    <features.f32> <features_lpc.f32>
    python -m lpcnet_torch.cli plc <causal|causal_dc|noncausal|noncausal_dc>
                                   <percent|pattern.txt> <input.pcm> <output.pcm>
    python -m lpcnet_torch.cli dred-encode  <input.pcm> <latents.f32>
    python -m lpcnet_torch.cli dred-decode  <latents.f32> <features.f32>
    python -m lpcnet_torch.cli dred-payload <input.pcm> <payload.bin>
    python -m lpcnet_torch.cli dred-payload-decode <payload.bin> <features.f32>
    python -m lpcnet_torch.cli fec-encode   <input.pcm> <packets.fec>
        [--model model.npz|model.bin|random] [--device cuda|cpu]

File formats are the C demo's: .pcm raw 16 kHz s16le mono, .f32 raw float32
feature rows of 36, .lpcnet 8-byte packets (40 ms each); a loss pattern is
one 0/1 flag per 20 ms packet. Sampling is the C bit tree, but for
`synthesis --sampling pdf`: the full-PDF sampler with the voicing
temperature of the reference's Python synthesis, one stream through the
frame network and the plain sample loop (no kernel: the sampler is plain
PyTorch, as in the JAX package). The model
(decode, synthesis, the causal plc modes) defaults to the shipped demo
vocoder (lpcnet_tpu/data/demo_model.npz, read as a file); the non-causal
plc modes need a lookahead-0 model and default to a seeded random one. The
plc modes run the shipped demo PLC network. Every mode runs on the GPU
unless `--device cpu` is passed.

The DRED modes run DRED's RDO-VAE (`--model` an RDO-VAE `.npz` or DNNw
blob, e.g. lpcnet_tpu/data/demo_rdovae_model.npz; without it a seeded
random init from numpy, which differs from the JAX package's
`jax.random.PRNGKey(0)` init): dred-encode writes the latents and, beside
them in `<latents.f32>.state`, the decoder-init states; dred-decode decodes
every second latent from the newest state; dred-payload writes one
entropy-coded redundancy payload of `--dred-frames` 10 ms frames;
dred-payload-decode decodes one (newest frame first); fec-encode writes a
.fec packet file of DRED-coded features, one packet per 20 ms, for
`plc.driver.run_plc_fec_stream`.
"""

from __future__ import annotations

import argparse

import numpy as np

from . import api
from .dsp.constants import (FRAME_SIZE, LPCNET_COMPRESSED_SIZE,
                            LPCNET_PACKET_SAMPLES, NB_TOTAL_FEATURES)


def _read_features(path):
    feats = np.fromfile(path, dtype=np.float32)
    n = len(feats) // NB_TOTAL_FEATURES
    return feats[:n * NB_TOTAL_FEATURES].reshape(n, NB_TOTAL_FEATURES)


def _synthesize_pdf(feats, model, device):
    """One stream through the frame network and the step-by-step sample
    loop with the full-PDF sampler (pdf_corr = feature 19), the state
    frozen and the output zero until the lookahead has filled, as the JAX
    package's cli. Returns the frames' PCM, int16 [160] each."""
    import torch

    from .models import lpcnet as M
    fused, cfg = api.load_model(model, device=device)
    dev = fused["embed_sig_a"].device
    fstate = M.init_frame_state(1, cfg, dev)
    sstate = M.init_sample_state(1, cfg, dev)
    out = []
    for f in feats:
        f = torch.from_numpy(np.ascontiguousarray(f[None])).to(dev)
        fstate, _, ca, cb, lpc = M.frame_network(fused, fstate, f, cfg)
        if int(fstate.frame_count[0]) > cfg.lookahead:
            sstate, pcm = M.synthesize_frame(fused, sstate, ca, cb, lpc,
                                             pdf_corr=f[:, 19])
            out.append(pcm[0].cpu().numpy().astype(np.int16))
        else:
            out.append(np.zeros(FRAME_SIZE, np.int16))
    return out


_DRED_MODES = ("dred-encode", "dred-decode", "dred-payload",
               "dred-payload-decode", "fec-encode")


def _stream_features(pcm, device):
    """The port's per-frame features of one stream's pcm, one [36] row a
    10 ms frame."""
    enc = api.lpcnet_encoder_create(device=device)
    n = len(pcm) // FRAME_SIZE
    for t in range(n):
        yield api.lpcnet_compute_single_frame_features(
            enc, pcm[t * FRAME_SIZE:(t + 1) * FRAME_SIZE])


def _encode_stream(pcm, params, cfg, device):
    from .dred.coder import DREDEncoder
    dred = DREDEncoder(params, cfg, device=device)
    for f in _stream_features(pcm, device):
        dred.add_feature_frame(f[None, :cfg.num_features])
    return dred


def _fec_encode(ns, pcm, params, cfg):
    """pcm -> .fec packets of DRED-coded features, one per 20 ms (the
    reference's torch fec_encoder.py tool: per packet quantize, unquantize,
    decode)."""
    import torch
    from .dred.coder import DREDDecoder, DREDEncoder, quantize_latents
    from .dred.fec_file import write_fec_packets
    if not ns.no_align:
        # input alignment (training_tf2/fec_encoder.py:82-115): 91 samples
        # to line up with SILK-decoded frames, a zero history long enough
        # that the first packet has a full redundancy span, minus the
        # feature pipeline's own 10 ms delay; the tail right-padded to a
        # whole 20 ms frame
        frame20 = 2 * FRAME_SIZE
        zero_history = (ns.num_redundancy_frames - 1) * frame20
        total_delay = ns.silk_delay + zero_history + ns.extra_delay - FRAME_SIZE
        right = (-(len(pcm) + total_delay)) % frame20
        pcm = np.concatenate([np.zeros(total_delay, pcm.dtype), pcm,
                              np.zeros(right, pcm.dtype)])
    dred = DREDEncoder(params, cfg, device=ns.device)
    dec = DREDDecoder(params, cfg, device=ns.device)
    q = np.array([ns.q0], np.int32)
    q_dev = torch.as_tensor(q, device=dred.device)
    packets, rates = [], []
    for t, f in enumerate(_stream_features(pcm, ns.device)):
        dred.add_feature_frame(f[None, :cfg.num_features])
        if t % 2 == 1 and dred.z_window:
            # the newest latent -> its own 2 frames at level q0
            zq, rate = quantize_latents(dred.params, dred.z_window[-1][:, None],
                                        q_dev, cfg)
            feats = dec.decode_all(zq, q, dred.state_window[-1])
            # decoded frames run newest first: [1, 0] are this packet's two
            packets.append(feats[0, :2][::-1])
            rates.append(int(rate.sum()))
    write_fec_packets(ns.args[1], packets, rates)
    print(f"fec-encode: {len(packets)} packets "
          f"(mean {np.mean(rates):.0f} bits/packet estimate)")


def _dred(ns):
    """The DRED modes."""
    from .dred.coder import DREDDecoder
    src, dst = ns.args
    params, cfg = api.load_rdovae_model(
        None if ns.model == "random" else ns.model, device=ns.device)
    if ns.mode in ("dred-encode", "dred-payload", "fec-encode"):
        pcm = np.fromfile(src, dtype=np.int16)
    if ns.mode == "dred-encode":
        # pcm -> latents and decoder-init states (f32 files), as
        # training_tf2/encode_rdovae.py
        dred = _encode_stream(pcm, params, cfg, ns.device)
        z = (np.concatenate(dred.latents, 0) if dred.z_window
             else np.zeros((0, cfg.latent_dim)))
        st = (np.concatenate(dred.init_states, 0) if dred.z_window
              else np.zeros((0, cfg.state_dim)))
        z.astype(np.float32).tofile(dst)
        st.astype(np.float32).tofile(dst + ".state")
        print(f"dred-encode: {len(dred.z_window)} latents")
    elif ns.mode == "dred-decode":
        z = np.fromfile(src, np.float32).reshape(1, -1, cfg.latent_dim)
        st = np.fromfile(src + ".state", np.float32).reshape(1, -1, cfg.state_dim)
        # decode from the newest state over every 2nd latent (the decoder's
        # stride)
        zsel = z[:, ::-2][:, ::-1]
        feats = DREDDecoder(params, cfg, device=ns.device).decode_all(
            zsel, np.zeros(zsel.shape[1], np.int32), st[:, -1])
        feats[0].astype(np.float32).tofile(dst)
        print(f"dred-decode: {feats.shape[1]} feature frames")
    elif ns.mode == "dred-payload":
        # pcm -> one entropy-coded redundancy payload
        dred = _encode_stream(pcm, params, cfg, ns.device)
        out = dred.produce_payload(num_redundancy_frames=ns.dred_frames,
                                   q0=ns.q0, q1=ns.q1)
        if out is None:
            print("input too short for requested redundancy depth")
            return 1
        payload = out["payloads"][0]
        with open(dst, "wb") as f:
            f.write(payload)
        kbps = len(payload) * 8 / (ns.dred_frames * 0.010) / 1000
        print(f"dred-payload: {len(payload)} bytes covering "
              f"{ns.dred_frames * 10} ms ({kbps:.2f} kbps redundancy)")
    elif ns.mode == "dred-payload-decode":
        with open(src, "rb") as f:
            payload = f.read()
        feats = DREDDecoder(params, cfg, device=ns.device).decode_payload(payload)
        feats[0].astype(np.float32).tofile(dst)
        print(f"dred-payload-decode: {feats.shape[1]} feature frames "
              f"(newest first)")
    else:
        _fec_encode(ns, pcm, params, cfg)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lpcnet_torch")
    ap.add_argument("mode", choices=["encode", "decode", "features",
                                     "synthesis", "addlpc", "plc",
                                     *_DRED_MODES])
    ap.add_argument("args", nargs="+", metavar="ARG")
    ap.add_argument("--model", default=None,
                    help="model weights (.npz checkpoint or DNNw blob); "
                         "default = the shipped demo vocoder (a seeded "
                         "random one for the non-causal plc modes); "
                         "'random' for a seeded random init. The DRED "
                         "modes take an RDO-VAE (.npz or DNNw blob); "
                         "without one they use a random init from numpy's "
                         "RandomState(0), which cannot reproduce the JAX "
                         "package's jax.random.PRNGKey(0) weights")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sampling", choices=["tree", "pdf"], default="tree",
                    help="synthesis: the C bit-tree sampler (default) or the "
                         "full-PDF voicing-temperature sampler of the "
                         "reference's Python synthesis")
    ap.add_argument("--dred-frames", type=int, default=52,
                    help="redundancy depth in 10 ms frames for dred-payload")
    ap.add_argument("--q0", type=int, default=9)
    ap.add_argument("--q1", type=int, default=15)
    ap.add_argument("--silk-delay", type=int, default=91,
                    help="fec-encode: samples of delay to align redundancy "
                         "with SILK-decoded frames (fec_encoder.py:88)")
    ap.add_argument("--extra-delay", type=int, default=0,
                    help="fec-encode: extra alignment delay in samples")
    ap.add_argument("--num-redundancy-frames", type=int, default=64,
                    help="fec-encode: redundancy depth in 20 ms frames; "
                         "sizes the zero history prepended so the first "
                         "packet has a full span (fec_encoder.py:91)")
    ap.add_argument("--no-align", action="store_true",
                    help="fec-encode: skip the SILK delay and zero-history "
                         "padding (raw per-frame packets)")
    ns = ap.parse_args(argv)
    n_args = 4 if ns.mode == "plc" else 2
    if len(ns.args) != n_args:
        ap.error(f"{ns.mode} takes {n_args} arguments")
    if ns.mode in _DRED_MODES:
        return _dred(ns)
    if ns.model == "random":
        model = None
    elif ns.model is not None:
        model = ns.model
    elif ns.mode == "plc" and ns.args[0].startswith("noncausal"):
        model = None                        # the demo vocoder has lookahead 2
    else:
        model = api.DEMO_MODEL_PATH

    if ns.mode == "plc":
        from .plc.driver import run_plc_file
        run_plc_file(*ns.args, model_path=model, device=ns.device)
        return
    src, dst = ns.args

    if ns.mode == "encode":
        pcm = np.fromfile(src, dtype=np.int16)
        enc = api.lpcnet_encoder_create(device=ns.device)
        n = len(pcm) // LPCNET_PACKET_SAMPLES
        pkts = [api.lpcnet_encode(enc, pcm[t * LPCNET_PACKET_SAMPLES:
                                           (t + 1) * LPCNET_PACKET_SAMPLES])
                for t in range(n)]
        np.array(pkts, np.uint8).reshape(-1).tofile(dst)
        print(f"encoded {n} packets ({n * LPCNET_COMPRESSED_SIZE} bytes, "
              f"{n * 40} ms)")

    elif ns.mode == "decode":
        data = np.fromfile(src, dtype=np.uint8)
        n = len(data) // LPCNET_COMPRESSED_SIZE
        dec = api.lpcnet_decoder_create(model, device=ns.device)
        out = [np.zeros(0, np.int16)] + [
            api.lpcnet_decode(dec, data[t * LPCNET_COMPRESSED_SIZE:
                                        (t + 1) * LPCNET_COMPRESSED_SIZE])
            for t in range(n)]
        np.concatenate(out).astype(np.int16).tofile(dst)
        print(f"decoded {n} packets -> {n * LPCNET_PACKET_SAMPLES} samples")

    elif ns.mode == "features":
        pcm = np.fromfile(src, dtype=np.int16)
        enc = api.lpcnet_encoder_create(device=ns.device)
        n = len(pcm) // FRAME_SIZE
        rows = [api.lpcnet_compute_single_frame_features(
            enc, pcm[t * FRAME_SIZE:(t + 1) * FRAME_SIZE]) for t in range(n)]
        np.array(rows, np.float32).reshape(-1).tofile(dst)
        print(f"wrote {n} feature frames")

    elif ns.mode == "synthesis":
        feats = _read_features(src)
        if ns.sampling == "pdf":
            out = [np.zeros(0, np.int16)] + _synthesize_pdf(feats, model, ns.device)
        else:
            synth = api.Synthesizer(model, batch=1, device=ns.device)
            out = [np.zeros(0, np.int16)] + [
                synth.synthesize(f[None])[0] for f in feats]
        np.concatenate(out).astype(np.int16).tofile(dst)
        print(f"synthesized {len(feats)} frames "
              f"({len(feats) * FRAME_SIZE} samples)")

    else:                                   # addlpc
        feats = _read_features(src)
        api.add_lpc_to_features(feats, device=ns.device).tofile(dst)
        print(f"added LPC to {len(feats)} frames")


if __name__ == "__main__":
    raise SystemExit(main())
