"""The least arithmetic of a DRED decoding tick, counted from the shapes of
configuration dred-rdovae-dec-256-80: the figures `mfu.dred_dec` divides
by the window. Only the products a tick needs, each once, at float32's
peak (the configuration's precision):

- once a payload, the decoder's initialisation: the three state denses
  (gru_1_init to gru_3_init) from the PVQ state;
- once a latent: dense_1, the three GRUs (input and recurrent products),
  dense_2 to dense_5 and the output dense over the concatenated outputs.

The parse (header, PVQ index, range decoding) and the unquantisation are
left out, as `work_dred.py` leaves out the coder: integer bookkeeping and
one division a symbol beside these products.
"""

from __future__ import annotations

from .peaks import PEAK


def decoder_init_macs(c: dict) -> int:
    """MACs of one stream's decoder initialisation."""
    return 3 * c["state_dim"] * c["cond_size"]


def decoder_latent_macs(c: dict) -> int:
    """MACs of one stream's decoder step (one latent, 4 feature frames)."""
    cs, c2 = c["cond_size"], c["cond_size2"]
    concat = 3 * cs + 5 * c2
    return (c["latent_dim"] * c2                                   # dense_1
            + 3 * (3 * cs * (c2 + cs))                             # GRU 1-3
            + 3 * cs * c2 + c2 * c2                                # dense_2..5
            + concat * c["dec_frames_per_step"] * c["num_features"])  # output


def tick_seconds(c: dict, streams: int, n_latents: int) -> float:
    """The least device time of one tick: a payload of `n_latents` latents
    a stream."""
    macs = decoder_init_macs(c) + n_latents * decoder_latent_macs(c)
    return streams * 2 * macs / PEAK["f32"]
