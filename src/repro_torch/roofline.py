"""Three-term roofline for the H100, PyTorch port of ``repro/roofline.py``.

    compute    = FLOPs_per_chip / PEAK_FLOPS
    memory     = HBM_bytes_per_chip / HBM_BW
    collective = wire_bytes_per_chip / LINK_BW

The reference reads its FLOPs, bytes and collectives from XLA's compiled
HLO; the port has no compiler to ask, so :func:`build_roofline` takes
counted FLOPs, bytes and wire bytes (``launch/dryrun.py`` counts them).
Wire bytes a collective puts on one chip's links follow from its local
result bytes with ring-algorithm factors (:func:`wire_bytes`):

    all-reduce        2 x bytes x (G-1)/G   (reduce-scatter + all-gather)
    all-gather        bytes x (G-1)/G       (result is the gathered copy)
    reduce-scatter    (G-1) x bytes         (result is the scattered shard)
    all-to-all        1 x bytes
    collective-permute 1 x bytes

Hardware constants: NVIDIA H100 SXM, 700 W, dense rates (NVIDIA's data
sheet): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM3, 80 GB of
it, NVLink 450 GB/s each way, and 67 T operations/s of 32-bit
arithmetic outside the tensor cores (the kernels' integer and float
operations in ``chip_smoke.py``).  A card set below 700 W runs slower.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12       # bf16 per chip, dense
HBM_BW = 3.35e12          # bytes/s per chip
HBM_BYTES = 80e9          # device memory per chip
LINK_BW = 450e9           # bytes/s per chip, NVLink each way
INT_OPS = 67e12           # 32-bit operations/s outside the tensor cores


def wire_bytes(op: str, result_bytes: int, group: int) -> int:
    """Bytes one chip sends for collective ``op`` over ``group`` chips whose
    local result is ``result_bytes``."""
    g = max(1, group)
    if op == "all-reduce":
        return 2 * result_bytes * (g - 1) // g
    if op == "all-gather":
        return result_bytes * (g - 1) // g
    if op == "reduce-scatter":
        return result_bytes * (g - 1)
    if op in ("all-to-all", "collective-permute"):
        return result_bytes
    raise ValueError(f"unknown collective {op!r}")


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    wire_bytes_per_chip: float
    model_flops: float               # 6*N(_active)*D tokens (global)
    collectives: Dict

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (chips * counted flops): recompute/redundancy waste."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_frac(self) -> float:
        """Useful model FLOP-time over the max of the three terms."""
        t_model = self.model_flops / self.chips / PEAK_FLOPS
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_model / t_bound if t_bound else 0.0

    def as_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
            "collectives": self.collectives,
        }


def model_flops_for(cfg, shape_kind: str, batch: int, seq: int) -> float:
    """6*N*D (train) / 2*N*D (prefill) / 2*N*B (decode step), N = active.

    Enc-dec models split the seq budget between the stacks (each sees s/2),
    so the token count is halved to keep the useful-FLOPs ratio honest.
    """
    n = cfg.param_count()["active"]
    if cfg.n_enc_layers:
        seq = max(1, seq // 2)
    if shape_kind == "train":
        return 6.0 * n * batch * seq
    if shape_kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch          # decode: one token per sequence


def build_roofline(arch: str, shape: str, mesh_name: str, chips: int,
                   flops_per_chip: float, hbm_bytes_per_chip: float,
                   wire_bytes_per_chip: float, model_flops: float,
                   collectives: Dict) -> Roofline:
    return Roofline(arch=arch, shape=shape, mesh=mesh_name, chips=chips,
                    flops_per_chip=float(flops_per_chip),
                    hbm_bytes_per_chip=float(hbm_bytes_per_chip),
                    wire_bytes_per_chip=float(wire_bytes_per_chip),
                    model_flops=model_flops, collectives=collectives)
