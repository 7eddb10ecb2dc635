"""hubert-xlarge [audio]: 48L d=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only transformer (the wav2vec2 backbone) — arXiv:2106.07447.  The
modality frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings [B, S, 1280] (the ``embeds`` input mode), and
training is frame-level cross-entropy over the 504 cluster targets.  GELU
MLP with biases, non-causal attention, an untied head.  The reference's
deviation is kept: RMSNorm, not LayerNorm.  No decode (encoder-only).

(Port of repro/configs/hubert_xlarge.py.)
"""
from repro_torch.configs.common import ENCODER_DECODE_SKIP, shrink
from repro_torch.models.transformer import ModelConfig

SKIP_SHAPES = {
    "decode_32k": ENCODER_DECODE_SKIP,
    "long_500k": ENCODER_DECODE_SKIP,
}


def full_config(**overrides) -> ModelConfig:
    cfg = ModelConfig(
        name="hubert-xlarge",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        mlp_type="gelu",
        causal=False,
        input_mode="embeds",
        embedding_method="alpt",  # the (small) 504-way table no loss reads
    )
    return shrink(cfg, **overrides)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=64,
        mlp_type="gelu",
        causal=False,
        input_mode="embeds",
        embedding_method="alpt",
        ce_chunk=32,
        attn_q_block=32,
        attn_k_block=32,
    )
