"""qwen2-vl-7b [vlm]: 28L d=3584 28H (kv=4) d_ff=18944 vocab=152064.

M-RoPE (temporal/height/width frequency sections 16/24/24 of head_dim 128)
and QKV bias — arXiv:2409.12191.  The vision frontend is a stub, as in the
reference: 256 precomputed patch embeddings replace the first 256 token
positions (the ``mixed`` input mode) and come with 3-stream positions.  The
head is untied.

(Port of repro/configs/qwen2_vl_7b.py.)
"""
from repro_torch.configs.common import FULL_ATTN_LONG_SKIP, shrink
from repro_torch.models.transformer import ModelConfig

SKIP_SHAPES = {"long_500k": FULL_ATTN_LONG_SKIP}


def full_config(**overrides) -> ModelConfig:
    cfg = ModelConfig(
        name="qwen2-vl-7b",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        attn_bias=True,
        mrope_sections=(16, 24, 24),
        input_mode="mixed",
        visual_prefix=256,
        embedding_method="alpt",
    )
    return shrink(cfg, **overrides)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        attn_bias=True,
        mrope_sections=(2, 3, 3),
        input_mode="mixed",
        visual_prefix=8,
        embedding_method="alpt",
        ce_chunk=32,
        attn_q_block=32,
        attn_k_block=32,
    )
