"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), the yardstick of
every roofline share the benchmark reports.

Source: NVIDIA H100 Tensor Core GPU data sheet, SXM form factor, dense
rates (no sparsity), at the full power limit of 700 W.  A card set below
700 W runs slower; every result line carries the card's name and the
run records its power limit where ``nvidia-smi`` gives it.

No integer peak is stated: the data sheet gives none for the 32-bit
integer units, so the kernels of the sketch folds are bounded by their
bytes alone (a lower bound of their time, hence an upper bound of the
share).
"""
HBM_BYTES_PER_S = 3.35e12  # HBM3 bandwidth
