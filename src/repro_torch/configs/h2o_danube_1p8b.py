"""h2o-danube-1.8b [dense]: 24L d=2560 32H (kv=8) d_ff=6912 vocab=32000.

llama+mistral mix with sliding-window attention — arXiv:2401.16818.
head_dim = 80; SWA window 4096 makes long_500k runnable.

(Port of repro/configs/h2o_danube_1p8b.py.)
"""
from repro_torch.configs.common import shrink
from repro_torch.models.transformer import ModelConfig


def full_config(**overrides) -> ModelConfig:
    cfg = ModelConfig(
        name="h2o-danube-1.8b",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        sliding_window=4096,
        embedding_method="alpt",
    )
    return shrink(cfg, **overrides)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        sliding_window=32,
        embedding_method="alpt",
        ce_chunk=32,
        attn_q_block=32,
        attn_k_block=32,
    )
