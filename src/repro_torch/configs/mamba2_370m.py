"""mamba2-370m [ssm]: 48L d_model=1024, attention-free, vocab=50280, state=128.

SSD (state-space duality), arXiv:2405.21060.  No MLP sub-layer (d_ff=0); each
layer is a single Mamba2 mixer.  d_inner = 2048, headdim 64 -> 32 SSD heads.
Tied embeddings (as released).  ALPT quantizes the 50280x1024 vocab table.

(Port of repro/configs/mamba2_370m.py.)
"""
from repro_torch.configs.common import shrink
from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ModelConfig

SKIP_SHAPES: dict[str, str] = {}  # SSM: all four shapes run (O(1) decode state)


def full_config(**overrides) -> ModelConfig:
    cfg = ModelConfig(
        name="mamba2-370m",
        n_layers=48,
        d_model=1024,
        n_heads=32,  # SSD heads (d_inner / headdim); no attention layers
        n_kv_heads=32,
        d_ff=0,
        vocab_size=50280,
        layer_types=("mamba",),
        ssm=SSMConfig(d_model=1024, d_state=128, headdim=64, expand=2),
        tie_embeddings=True,
        embedding_method="alpt",
    )
    return shrink(cfg, **overrides)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke",
        n_layers=4,
        d_model=64,
        n_heads=8,
        n_kv_heads=8,
        d_ff=0,
        vocab_size=512,
        layer_types=("mamba",),
        ssm=SSMConfig(d_model=64, d_state=32, headdim=16, expand=2, chunk=32),
        tie_embeddings=True,
        embedding_method="alpt",
        ce_chunk=32,
    )
