"""Model stack (PyTorch port of ``repro/models``): every family's init,
forward, loss, prefill and decode (transformer.py) over attention, the
Mamba2 mixer (ssm.py) and the MoE FFN (moe.py)."""
