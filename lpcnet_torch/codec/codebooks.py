"""Cepstral VQ codebooks of the 1.6 kb/s codec: loading, saving, training.

The reference ships its codebooks as generated C arrays (ceps_codebooks.c,
trained offline by src/ceps_vq_train.c). Here they are an .npz with keys
ceps_codebook1/2/3 ([1024, 17], the three stages of the endpoint frame's
cepstrum 1..17) and ceps_codebook_diff4 ([4096, 18], the signed
multi-predictor codebook of the mid frame). The shipped set is read by path
from the JAX package's data folder.

    python -m lpcnet_torch.codec.codebooks features.f32 out.npz [--eval]

`train_codebooks` is the counterpart of the JAX package's trainer, on the
card unless the caller passes `device="cpu"`:

* stage books follow the reference's LBG recipe (vq_train, :339-367):
  global-mean init, split-doubling by a +-delta perturbation, 4 Lloyd
  updates per doubling, 20 final updates; stages 2 and 3 train on the
  greedy residuals of the stages before (:488-534);
* an m-best-aware refinement then moves all three stage books to the means
  of the runtime's joint beam assignments (`quantize.quantize_3stage_mbest`),
  the quantizer that uses them;
* the diff book is vq_train_multi with sign search (:368-403, update_multi
  :113-296): entry i scores against the residual of predictor group i & 3 in
  both signs, and its update folds the sign in; its targets are residuals
  against the 3-stage-quantized endpoints (:537-562).

Assignments are `torch.argmin` (the first index on ties, as `jnp.argmin`);
counts and sums are `torch.bincount` and `index_add_`, and an empty cell
keeps its centroid. The beam runs over the rows in chunks of `CHUNK`, so
its [rows, 5, 1024] distances stay bounded. Every random perturbation is
drawn by `_uniform` on a CPU generator and moved to the device, so a run on
the card and one on the CPU see the same draws from one seed.
`train_codebooks` trains in float64 and returns float32 books: in float32
the card's and the CPU's sums round apart, an assignment on a near-tie
flips, and the books drift apart from there (by up to 6.2 between an H100
and the CPU at 64 codes on 8k frames); the helpers keep their inputs'
type.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .quantize import quantize_3stage_mbest, quantize_diff

DEFAULT_PATH = str(Path(__file__).resolve().parents[2] / "lpcnet_tpu"
                   / "data" / "codebooks.npz")


class Codebooks(NamedTuple):
    stage1: torch.Tensor   # [1024, 17]
    stage2: torch.Tensor   # [1024, 17]
    stage3: torch.Tensor   # [1024, 17]
    diff4: torch.Tensor    # [4096, 18]


def load_codebooks(path: str | None = None, device="cpu") -> Codebooks:
    d = np.load(path or DEFAULT_PATH)
    t = lambda k: torch.as_tensor(d[k], dtype=torch.float32, device=device)
    return Codebooks(t("ceps_codebook1"), t("ceps_codebook2"),
                     t("ceps_codebook3"), t("ceps_codebook_diff4"))


def save_codebooks(path: str, cb: Codebooks) -> None:
    n = lambda x: x.detach().cpu().numpy()
    np.savez(path, ceps_codebook1=n(cb.stage1), ceps_codebook2=n(cb.stage2),
             ceps_codebook3=n(cb.stage3), ceps_codebook_diff4=n(cb.diff4))


CHUNK = 4096    # rows of one beam or diff-quantizer pass


def _uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    """U(0, 1) float32 of `shape` from the CPU `generator`, on `device`:
    the one source of the trainer's random perturbations."""
    return torch.rand(shape, generator=generator, dtype=torch.float32
                      ).to(device)


def _perturbation(generator, codes):
    """0.01 (U - 0.5) of `codes`' shape, in `codes`' type."""
    return 0.01 * (_uniform(generator, codes.shape, codes.device)
                   .to(codes.dtype) - 0.5)


def _dist2(x, codes):
    return ((x * x).sum(1, keepdim=True) - 2.0 * x @ codes.T
            + (codes * codes).sum(1))


def _cell_means(assign, values, codes):
    """The mean of `values` [N, d] over each cell of `assign` [N]; an empty
    cell keeps its row of `codes` (the reference divides by zero there)."""
    counts = torch.bincount(assign, minlength=codes.shape[0]
                            ).to(values.dtype)[:, None]
    sums = torch.zeros_like(codes).index_add_(0, assign, values)
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), codes)


def _lloyd(data, codes, iters: int):
    """`iters` Lloyd updates. Returns (codes, errors [iters]), each error
    the summed squared distance under the codes before that update."""
    errs = []
    for _ in range(iters):
        d2 = _dist2(data, codes)
        assign = torch.argmin(d2, dim=1)
        errs.append(d2.gather(1, assign[:, None]).sum())
        codes = _cell_means(assign, data, codes)
    return codes, torch.stack(errs) if errs else data.new_zeros(0)


def _lbg_train(data, n_codes: int, generator: torch.Generator,
               split_updates: int = 4, final_updates: int = 20):
    """The reference's LBG recipe (vq_train, src/ceps_vq_train.c:339-367):
    mean init, +-delta split to double, `split_updates` Lloyd updates per
    doubling, `final_updates` at full size."""
    codes = data.mean(0, keepdim=True)
    e = 1
    while e < n_codes:
        delta = _perturbation(generator, codes)
        codes = torch.cat([codes + delta, codes - delta], dim=0)
        e <<= 1
        codes, _ = _lloyd(data, codes, split_updates)
    codes, _ = _lloyd(data, codes, final_updates)
    return codes


def _chunked(fn, n: int, *rows):
    """fn over row chunks of CHUNK of the [n, ...] tensors `rows`, its
    outputs (a tuple of tensors) concatenated."""
    outs = [fn(*(r[i:i + CHUNK] for r in rows)) for i in range(0, n, CHUNK)]
    return tuple(torch.cat(o, dim=0) for o in zip(*outs))


def _beam_assign(x, cb1, cb2, cb3):
    """The runtime m-best beam's joint (i1, i2, i3) [N, 3] int32 and
    reconstruction [N, 17], in row chunks."""
    return _chunked(lambda v: quantize_3stage_mbest(v, cb1, cb2, cb3),
                    x.shape[0], x)


def _mbest_refine_once(x, cb1, cb2, cb3):
    """One coordinate-descent Lloyd pass on the additive 3-stage model with
    the beam's joint assignments: each stage's entry moves to the mean of
    (x - the other stages' contributions) over its assignments."""
    idx, _ = _beam_assign(x, cb1, cb2, cb3)
    i1, i2, i3 = (idx[:, k].long() for k in range(3))
    cb1 = _cell_means(i1, x - (cb2[i2] + cb3[i3]), cb1)
    cb2 = _cell_means(i2, x - (cb1[i1] + cb3[i3]), cb2)
    cb3 = _cell_means(i3, x - (cb1[i1] + cb2[i2]), cb3)
    return cb1, cb2, cb3


def _diff_residuals(mid, left, right):
    """The mid frame's residual against each predictor group [N, 4, 18]
    (multi_data2, src/ceps_vq_train.c:551-562: groups 0 and 1 are both the
    mean predictor, 2 the left endpoint, 3 the right)."""
    mean = 0.5 * (left + right)
    return torch.stack([mid - mean, mid - mean, mid - left, mid - right],
                       dim=1)


def _lloyd_multi_sign(res, codes, iters: int):
    """Sign-folded multi-predictor Lloyd (update_multi with sign=1,
    src/ceps_vq_train.c:255-296): entry i scores against res[:, i & 3] in
    both signs, and its update accumulates sign * its group's residual.
    Returns (codes, errors [iters])."""
    n_codes = codes.shape[0]
    rows = torch.arange(res.shape[0], device=res.device)
    group = torch.arange(n_codes, device=res.device) & 3
    rsq = (res * res).sum(2)                              # [N, 4]
    rsq_g = rsq[:, group]                                 # [N, K]
    errs = []
    for _ in range(iters):
        cross_g = res.new_empty(res.shape[0], n_codes)
        for g in range(4):
            cross_g[:, g::4] = res[:, g] @ codes[g::4].T
        csq = (codes * codes).sum(1)
        d_pos = rsq_g - 2.0 * cross_g + csq
        d_neg = rsq_g + 2.0 * cross_g + csq
        entry = torch.argmin(torch.cat([d_pos, d_neg], dim=1), dim=1)
        idx = entry % n_codes
        sign = torch.where(entry < n_codes, 1.0, -1.0).to(res.dtype)
        res_sel = res[rows, idx & 3]                      # [N, 18]
        errs.append(torch.minimum(d_pos.min(1).values,
                                  d_neg.min(1).values).sum())
        codes = _cell_means(idx, sign[:, None] * res_sel, codes)
    return codes, torch.stack(errs) if errs else res.new_zeros(0)


def _train_multi_sign(res, n_codes: int, generator: torch.Generator,
                      split_updates: int = 4, final_updates: int = 20,
                      init_updates: int = 10):
    """vq_train_multi (src/ceps_vq_train.c:368-403): per-group mean init
    with a perturbation, `init_updates` updates at size 4, split-doubling
    with `split_updates` each, `final_updates` at full size."""
    codes = res.mean(0)                                   # [4, 18]
    codes = codes + _perturbation(generator, codes)
    codes, _ = _lloyd_multi_sign(res, codes, init_updates)
    e = 4
    while e < n_codes:
        delta = _perturbation(generator, codes)
        # the reference appends the second child at offset e (:160-171); e
        # is a multiple of 4, so (i + e) & 3 == i & 3 keeps the groups
        codes = torch.cat([codes + delta, codes - delta], dim=0)
        e <<= 1
        codes, _ = _lloyd_multi_sign(res, codes, split_updates)
    codes, _ = _lloyd_multi_sign(res, codes, final_updates)
    return codes


def _corpus(features, device, dtype=torch.float32):
    """(endpoint frames [M, 18], mid frames [M - 1, 18]) of a feature
    corpus: the absolutely coded frames (every 4th, offset 3) and the
    midpoints between consecutive ones (src/lpcnet_enc.c:704-711)."""
    f = torch.as_tensor(np.asarray(features, np.float32)[:, :18],
                        device=device).to(dtype)
    n = (f.shape[0] - 4) // 4 * 4
    return f[3:3 + n:4], f[5:5 + n - 4:4]


def _neighbours(qends, m: int):
    """The left and right quantized endpoints of the first `m` mids."""
    return qends[:-1][:m], qends[1:][:m]


def quantization_mse(features, cb: Codebooks) -> dict:
    """Endpoint and diff quantization MSE of a feature corpus [N, >=18]
    under the *runtime* quantizers, on `cb`'s device: the figure to compare
    codebook sets by."""
    ends, mid = _corpus(features, cb.stage1.device)
    x = ends[:, 1:]
    _, recon = _beam_assign(x, cb.stage1, cb.stage2, cb.stage3)
    stage_mse = float(((x - recon) ** 2).sum(1).mean())
    qends = torch.cat([ends[:, :1], recon], dim=1)
    left, right = _neighbours(qends, mid.shape[0])
    _, drecon = _chunked(lambda m, l, r: quantize_diff(m, l, r, cb.diff4),
                         mid.shape[0], mid, left, right)
    diff_mse = float(((mid - drecon) ** 2).sum(1).mean())
    return {"stage_mse": stage_mse, "diff_mse": diff_mse}


def train_codebooks(features, generator: Optional[torch.Generator] = None,
                    split_updates: int = 4, final_updates: int = 20,
                    mbest_refine: int = 4, stage_codes: int = 1024,
                    diff_codes: int = 4096, device=None) -> Codebooks:
    """Train the 3-stage and diff codebooks from a feature corpus.

    features: [N, >=18] unquantized feature frames (numpy or a tensor), as
    `codec.features` or `train.dump_data` write them. generator: a CPU
    `torch.Generator` for the perturbations (default seed 0).
    mbest_refine: joint passes with the runtime's beam assignments after
    the LBG recipe (0 disables). Returns the books on `device` (the card
    unless the caller passes `device="cpu"`).
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    ends, mid = _corpus(features, dev, torch.float64)
    x = ends[:, 1:]                                       # [M, 17]
    cb1 = _lbg_train(x, stage_codes, generator, split_updates, final_updates)
    r1 = x - cb1[torch.argmin(_dist2(x, cb1), dim=1)]
    cb2 = _lbg_train(r1, stage_codes, generator, split_updates,
                     final_updates)
    r2 = r1 - cb2[torch.argmin(_dist2(r1, cb2), dim=1)]
    cb3 = _lbg_train(r2, stage_codes, generator, split_updates,
                     final_updates)
    for _ in range(mbest_refine):
        cb1, cb2, cb3 = _mbest_refine_once(x, cb1, cb2, cb3)

    # the diff book's targets: the mid frame against predictors built from
    # the *quantized* endpoints (the reference's qdata, :537-562), c0
    # carried through unquantized as the reference does
    _, recon = _beam_assign(x, cb1, cb2, cb3)
    qends = torch.cat([ends[:, :1], recon], dim=1)        # [M, 18]
    left, right = _neighbours(qends, mid.shape[0])
    res = _diff_residuals(mid, left, right)               # [M - 1, 4, 18]
    cb_diff = _train_multi_sign(res, diff_codes, generator, split_updates,
                                final_updates)
    return Codebooks(*(b.to(torch.float32) for b in (cb1, cb2, cb3, cb_diff)))


def main(argv=None):
    """Train codebooks from a dump_data feature file (36 float32 a frame),
    the counterpart of the reference's offline trainer
    (src/ceps_vq_train.c)."""
    import argparse

    ap = argparse.ArgumentParser(prog="lpcnet_torch.codec.codebooks")
    ap.add_argument("features", help="f32 feature file (36 floats/frame)")
    ap.add_argument("output", help="output .npz codebook file")
    ap.add_argument("--split-updates", type=int, default=4)
    ap.add_argument("--final-updates", type=int, default=20)
    ap.add_argument("--mbest-refine", type=int, default=4)
    ap.add_argument("--max-frames", type=int, default=200000)
    ap.add_argument("--eval", action="store_true",
                    help="report the runtime quantizers' MSE for the trained "
                         "set and the shipped set")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    feats = np.fromfile(args.features, np.float32).reshape(-1, 36)
    feats = feats[: args.max_frames]
    cb = train_codebooks(feats, split_updates=args.split_updates,
                         final_updates=args.final_updates,
                         mbest_refine=args.mbest_refine, device=dev)
    save_codebooks(args.output, cb)
    print(f"trained codebooks from {len(feats)} frames -> {args.output}")
    if args.eval:
        print("trained:", quantization_mse(feats, cb))
        print("shipped:", quantization_mse(feats, load_codebooks(device=dev)))
    return 0


if __name__ == "__main__":
    main()
