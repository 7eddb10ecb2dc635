"""deepseek-moe-16b [moe]: 28L d=2048 16H (MHA kv=16) d_ff=1408 vocab=102400.

Fine-grained MoE: 64 routed experts top-6 plus 2 shared (always-on) experts,
arXiv:2401.06066.  Deviation note (the reference's): the released model's
layer 0 is a dense MLP (d_ff 10944); every layer is routed here to keep the
period at 1, and the parameter count differs by <1%.

(Port of repro/configs/deepseek_moe_16b.py.)
"""
from repro_torch.configs.common import FULL_ATTN_LONG_SKIP, shrink
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig

SKIP_SHAPES = {"long_500k": FULL_ATTN_LONG_SKIP}  # full (non-windowed) attention


def full_config(**overrides) -> ModelConfig:
    cfg = ModelConfig(
        name="deepseek-moe-16b",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        layer_types=("attn",),
        moe_pattern=(True,),
        moe=MoEConfig(
            n_experts=64,
            top_k=6,
            d_model=2048,
            d_ff=1408,
            n_shared_experts=2,
            shared_d_ff=2816,
            normalize_gates=False,  # deepseek-moe keeps raw top-k probs
        ),
        embedding_method="alpt",
    )
    return shrink(cfg, **overrides)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        vocab_size=512,
        layer_types=("attn",),
        moe_pattern=(True,),
        moe=MoEConfig(
            n_experts=8, top_k=3, d_model=64, d_ff=32,
            n_shared_experts=2, shared_d_ff=64, normalize_gates=False,
        ),
        embedding_method="alpt",
        ce_chunk=32,
        attn_q_block=32,
        attn_k_block=32,
    )
