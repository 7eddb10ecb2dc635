"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (kv=8) d_ff=14336 vocab=65536.

Mamba + attention at 1:7 (one attention layer per 8-layer period, position 4)
and MoE (16 experts, top-2) on every second layer, arXiv:2403.19887.  Mamba
sub-layers use d_state=16 (Jamba's value).

(Port of repro/configs/jamba_v01_52b.py.)
"""
from repro_torch.configs.common import shrink
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ModelConfig

SKIP_SHAPES: dict[str, str] = {}  # hybrid: sub-quadratic, all shapes run

_PERIOD = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")
_MOE = (False, True, False, True, False, True, False, True)


def full_config(**overrides) -> ModelConfig:
    cfg = ModelConfig(
        name="jamba-v0.1-52b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        layer_types=_PERIOD,
        moe_pattern=_MOE,
        moe=MoEConfig(n_experts=16, top_k=2, d_model=4096, d_ff=14336),
        ssm=SSMConfig(d_model=4096, d_state=16, headdim=64, expand=2),
        embedding_method="alpt",
    )
    return shrink(cfg, **overrides)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        n_layers=8,  # one full period
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        layer_types=_PERIOD,
        moe_pattern=_MOE,
        moe=MoEConfig(n_experts=4, top_k=2, d_model=64, d_ff=128),
        ssm=SSMConfig(d_model=64, d_state=16, headdim=16, expand=2, chunk=32),
        embedding_method="alpt",
        ce_chunk=32,
    )
