"""deepseek-67b [dense]: 95L d=8192 64H (kv=8) d_ff=22016 vocab=102400.

llama-arch at 67B — arXiv:2401.02954.  ``remat``: each layer group's
forward is recomputed in the backward (``torch.utils.checkpoint``), so a
step keeps one group's inputs, not its activations.  The untied head is
fp32 [102,400, 8,192].  Its fp32 training state (16 B a parameter with
Adam) does not fit one card at full depth: the card runs it at full width
with the depth cut.

(Port of repro/configs/deepseek_67b.py.)
"""
from repro_torch.configs.common import FULL_ATTN_LONG_SKIP, shrink
from repro_torch.models.transformer import ModelConfig

SKIP_SHAPES = {"long_500k": FULL_ATTN_LONG_SKIP}


def full_config(**overrides) -> ModelConfig:
    cfg = ModelConfig(
        name="deepseek-67b",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=102400,
        embedding_method="alpt",
        remat=True,  # activation checkpointing per layer group
    )
    return shrink(cfg, **overrides)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b-smoke",
        n_layers=3,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        embedding_method="alpt",
        remat=True,
        ce_chunk=32,
        attn_q_block=32,
        attn_k_block=32,
    )
