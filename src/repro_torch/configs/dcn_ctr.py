"""The paper's own architecture: DCN on synthetic Criteo / Avazu (port of
repro/configs/dcn_ctr.py).

Appendix B: Avazu — cross/deep depth 3, deep widths 1024/512/256;
Criteo — depth 5, width 1000, dropout 0.2.  Embedding dim 16 (§4.1).
``scale`` shrinks the vocabulary only; ``scale=1.0`` is the full
4,428,281-row Avazu table.
"""
from repro_torch.core.alpt import ALPTConfig
from repro_torch.data import ctr_synth
from repro_torch.methods import EmbeddingSpec
from repro_torch.models.ctr import DCNConfig


def avazu_setup(method: str = "alpt", bits: int = 8, scale: float = 0.01):
    data_cfg = ctr_synth.avazu_like(scale=scale)
    spec = EmbeddingSpec(
        method=method, n=data_cfg.n_features, d=16, bits=bits,
        alpt=ALPTConfig(bits=bits, step_lr=2e-5, weight_decay=5e-8),
    )
    dcn = DCNConfig(
        n_fields=data_cfg.n_fields, emb_dim=16, cross_depth=3,
        mlp_widths=(1024, 512, 256),
    )
    return data_cfg, spec, dcn


def criteo_setup(method: str = "alpt", bits: int = 8, scale: float = 0.01):
    data_cfg = ctr_synth.criteo_like(scale=scale)
    spec = EmbeddingSpec(
        method=method, n=data_cfg.n_features, d=16, bits=bits,
        alpt=ALPTConfig(bits=bits, step_lr=2e-5, weight_decay=1e-5),
    )
    dcn = DCNConfig(
        n_fields=data_cfg.n_fields, emb_dim=16, cross_depth=5,
        mlp_widths=(1000,) * 5, dropout=0.2,
    )
    return data_cfg, spec, dcn
