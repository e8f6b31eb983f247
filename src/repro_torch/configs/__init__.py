"""Architecture registry: ``get_config(arch)`` / ``get_reduced(arch)``
(PyTorch port of ``repro/configs``: the same ten configs, plain data).

All ten assigned architectures plus the paper's own workload are selectable
via ``--arch <id>`` in the launchers.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
}

ARCHS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    return importlib.import_module(_MODULES[arch]).REDUCED


# ---------------------------------------------------------------------------
# Assigned input shapes (LM-family: seq_len x global_batch).  decode_* and
# long_* lower serve_step (one token against a seq_len KV cache), not
# train_step; long_500k requires sub-quadratic decode (cfg.sub_quadratic).
# ---------------------------------------------------------------------------
SHAPES = {
    "train_4k": {"kind": "train", "seq_len": 4_096, "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32_768, "global_batch": 32},
    "decode_32k": {"kind": "decode", "seq_len": 32_768, "global_batch": 128},
    "long_500k": {"kind": "decode", "seq_len": 524_288, "global_batch": 1},
}


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    """Which (arch x shape) cells run (skips recorded in DESIGN.md S7)."""
    if shape == "long_500k":
        return cfg.sub_quadratic
    return True
