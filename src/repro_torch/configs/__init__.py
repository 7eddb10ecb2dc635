"""Configurations of the port: the paper's DCN setups (``dcn_ctr``) and the
LM architecture registry (port of repro/configs/__init__.py).

``--arch <id>`` resolves here.  The registry holds every architecture of
the reference's: the dense attention-only stacks, deepseek-67b (``remat``),
mamba2 (SSM), the MoE stacks, Jamba's hybrid, the encoder (hubert-xlarge:
the ``embeds`` input mode, the gelu MLP, non-causal attention) and the VLM
(qwen2-vl-7b: M-RoPE, QKV bias, the ``mixed`` input mode).
"""
from __future__ import annotations

import importlib

ARCHS = {
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1p8b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
}


def get_arch(name: str):
    """The config module of an architecture id."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name])


def full_config(name: str, **overrides):
    return get_arch(name).full_config(**overrides)


def smoke_config(name: str):
    return get_arch(name).smoke_config()
