"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W power limit). Frozen copy of
`chip_smoke.py`'s `PEAK` and `HBM_BPS` at commit d7e6271."""

HBM_BPS = 3.35e12
PEAK = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
