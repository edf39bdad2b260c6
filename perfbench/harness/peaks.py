"""Published peaks of one NVIDIA H100 SXM 80GB (NVIDIA's data sheet, dense
rates at the 700 W power limit): the yardstick of every roofline and MFU
share.  A run prints the card's name and power limit beside them."""

BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
