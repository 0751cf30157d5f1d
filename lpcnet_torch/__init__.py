"""lpcnet_torch: the LPCNet vocoder in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (sm_90a).

A port of `lpcnet_tpu` (JAX/Pallas) that imports neither JAX nor the JAX
package. Module names mirror `lpcnet_tpu` so each counterpart is easy to
find. It covers vocoder synthesis (per-frame features -> the frame-rate
network -> the 160-step autoregressive sample loop, the CUDA kernel in
`kernels/csrc/sample_loop.cu` -> 16-bit PCM) and vocoder training
(`train/train_lpcnet.py`: the teacher-forced training graph whose two GRU
recurrences run through the CUDA kernels of `kernels/csrc/gru_train.cu`,
forward and backward, with optional scheduled sampling through the masked
form of the sample loop), batched packet-loss concealment, causal and
non-causal (`runtime.serving.PLCStreamPool`), the reference's host PLC state
machine (`plc.plc.PLC`, `cli plc`), the reference's DNNw weight blobs
(`weights.lpcnet_arrays`, `weights.aux_arrays`), the 1.6 kb/s codec (`codec.encoder`,
packet decode through `runtime.serving.StreamPool`, whose sample loop can be
the merged-product kernel) and DRED (`models.rdovae`, the RDO-VAE;
`dred.coder`, its streaming encoder and decoder; `dred.entropy`, the
redundancy payloads), the training pipeline (`train.*`: the vocoder, PLC and
RDO-VAE trainers, one step at a time or in device-gathered blocks
(`train_block`), data-parallel over `torch.distributed` with
`parallel.mesh`), codebook training (`codec.codebooks.train_codebooks`)
and the Padé fitter (`utils.pade`).

Entry points (`api.load_model`, `api.Synthesizer`, `api.StreamPool`,
`api.PLCStreamPool`, `api.lpcnet_encoder_create`,
`api.lpcnet_decoder_create`, `codec.decoder.LPCNetDecoder.from_fused`,
`api.load_rdovae_model`, `dred.coder.DREDEncoder` / `DREDDecoder`,
`cli`, `train.train_lpcnet.Trainer` and its `main`,
`train.data.DeviceLPCNetLoader`, `codec.codebooks.train_codebooks` and its
`main`, `parallel.mesh.make_mesh`, `utils.pade.fit_pade_odd`) run on the GPU unless the caller passes
`device="cpu"`; without CUDA and without that request they raise.
"""

__version__ = "0.1.0"
