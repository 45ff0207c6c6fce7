"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at the card's full 700 W).  Shares are stated against
these; the run's card and its power limit are recorded beside them."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
