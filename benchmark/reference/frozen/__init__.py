"""A frozen copy of the plain (non-kernel) paths of `lpcnet_torch`, taken at
commit d7e6271: the DSP, the layers, the vocoder and PLC models, the codec's
packet and feature code, the causal batched PLC step and the training loss.
The references of the benchmark's configurations run on it. It imports
nothing of `lpcnet_torch`, so later changes to the program do not move it."""
