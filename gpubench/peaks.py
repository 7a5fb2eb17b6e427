"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at
the 700 W power limit), against which shares of a peak and rooflines
are stated."""

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
