"""qwen3-1.7b [dense]: 28L d=2048 16H (kv=8) d_ff=6144 vocab=151936.

QK-RMSNorm per head, GQA, head_dim=128, tied embeddings [hf:Qwen/Qwen3-8B
family].  The 151936x2048 vocab table is the arch's biggest single tensor —
the strongest LM case for the paper's technique (~19% of params).

(Port of repro/configs/qwen3_1p7b.py.)
"""
from repro_torch.configs.common import shrink
from repro_torch.models.transformer import ModelConfig


def full_config(**overrides) -> ModelConfig:
    cfg = ModelConfig(
        name="qwen3-1.7b",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        vocab_size=151936,
        qk_norm=True,
        rope_base=1_000_000.0,
        tie_embeddings=True,
        embedding_method="alpt",
    )
    return shrink(cfg, **overrides)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        qk_norm=True,
        tie_embeddings=True,
        embedding_method="alpt",
        ce_chunk=32,
        attn_q_block=32,
        attn_k_block=32,
    )
