"""lpcnet_torch: the LPCNet vocoder in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (sm_90a).

A port of `lpcnet_tpu` (JAX/Pallas) that imports neither JAX nor the JAX
package. Module names mirror `lpcnet_tpu` so each counterpart is easy to
find. This slice covers vocoder synthesis: per-frame features -> the
frame-rate network -> the 160-step autoregressive sample loop (the CUDA
kernel in `kernels/csrc/sample_loop.cu`) -> 16-bit PCM.

Entry points (`api.load_model`, `api.Synthesizer`, `codec.decoder.
LPCNetDecoder.from_fused`, `cli`) run on the GPU unless the caller passes
`device="cpu"`; without CUDA and without that request they raise.
"""

__version__ = "0.1.0"
