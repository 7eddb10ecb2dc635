"""mixtral-8x7b [moe]: 32L d=4096 32H (kv=8) d_ff=14336 vocab=32000.

8 experts, top-2, sliding-window attention (4096), arXiv:2401.04088.  SWA
keeps the decode cache window-sized (a ring buffer).

(Port of repro/configs/mixtral_8x7b.py.)
"""
from repro_torch.configs.common import shrink
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig

SKIP_SHAPES: dict[str, str] = {}  # SWA -> sub-quadratic decode, all shapes run


def full_config(**overrides) -> ModelConfig:
    cfg = ModelConfig(
        name="mixtral-8x7b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        layer_types=("attn",),
        moe_pattern=(True,),
        moe=MoEConfig(n_experts=8, top_k=2, d_model=4096, d_ff=14336),
        sliding_window=4096,
        embedding_method="alpt",
    )
    return shrink(cfg, **overrides)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        layer_types=("attn",),
        moe_pattern=(True,),
        moe=MoEConfig(n_experts=4, top_k=2, d_model=64, d_ff=128),
        sliding_window=32,
        embedding_method="alpt",
        ce_chunk=32,
        attn_q_block=32,
        attn_k_block=32,
    )
