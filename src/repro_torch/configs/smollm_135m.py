"""smollm-135m [dense]: 30L d=576 9H (kv=3) d_ff=1536 vocab=49152.

llama-arch small model [hf:HuggingFaceTB/SmolLM-135M]; tied embeddings.
9 heads don't divide a 16-way tensor axis — the dry-run policy pads q-heads
to 16 / kv to 4 (layers.pad_heads; DESIGN.md §5).

(Port of repro/configs/smollm_135m.py.)
"""
from repro_torch.configs.common import shrink
from repro_torch.models.transformer import ModelConfig


def full_config(**overrides) -> ModelConfig:
    cfg = ModelConfig(
        name="smollm-135m",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_ff=1536,
        vocab_size=49152,
        tie_embeddings=True,
        embedding_method="alpt",
    )
    return shrink(cfg, **overrides)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke",
        n_layers=3,
        d_model=48,
        n_heads=3,  # keeps the 3:1 GQA ratio of the full model
        n_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        tie_embeddings=True,
        embedding_method="alpt",
        ce_chunk=32,
        attn_q_block=32,
        attn_k_block=32,
    )
