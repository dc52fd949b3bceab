"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity), at its full 700 W power limit. A run prints the card's
``power.limit`` beside every share it reports."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
