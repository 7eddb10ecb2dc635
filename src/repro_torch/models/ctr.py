"""DCN CTR backbone (port of repro/models/ctr.py; DeepFM comes later).

The model takes already-looked-up embedding rows [B, F, d], so the same
forward serves every embedding method.  Parameters keep the reference's
layout — an MLP weight is ``[in, out]`` and applied as ``h @ w`` — so
:meth:`DCN.load_jax_params` / :meth:`DCN.jax_params` move them across
without a transpose.  The matmuls are plain PyTorch, as they are plain XLA
in the reference; entry points turn TF32 off (:mod:`repro_torch.device`).

Paper Appendix B: DCN with cross/deep depth 3 (widths 1024/512/256) for
Avazu, depth 5 (width 1000) for Criteo.  Dropout is a training concern and
comes with the training slice; the forward here is the inference forward.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    n_fields: int
    emb_dim: int
    cross_depth: int = 3
    mlp_widths: tuple[int, ...] = (1024, 512, 256)
    dropout: float = 0.0

    @property
    def input_dim(self) -> int:
        return self.n_fields * self.emb_dim


class DCN(nn.Module):
    """Deep & Cross Network: cross layers beside an MLP, one logit per row."""

    def __init__(self, cfg: DCNConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d0 = cfg.input_dim

        def vec(n):
            return nn.Parameter(torch.zeros(n, dtype=torch.float32, device=device))

        self.cross_w = nn.ParameterList([vec(d0) for _ in range(cfg.cross_depth)])
        self.cross_b = nn.ParameterList([vec(d0) for _ in range(cfg.cross_depth)])
        widths = (d0, *cfg.mlp_widths)
        self.mlp_w = nn.ParameterList([
            nn.Parameter(torch.zeros(i, o, dtype=torch.float32, device=device))
            for i, o in zip(widths[:-1], widths[1:])
        ])
        self.mlp_b = nn.ParameterList([vec(o) for o in cfg.mlp_widths])
        self.out_w = vec(d0 + widths[-1])
        self.out_b = vec(())

    def forward(self, rows: torch.Tensor) -> torch.Tensor:
        """Logits [B] from embedding rows [B, F, d]."""
        b = rows.shape[0]
        x0 = rows.reshape(b, -1)
        # Cross network: x_{l+1} = x0 * (x_l . w_l) + b_l + x_l
        x = x0
        for w, bias in zip(self.cross_w, self.cross_b):
            xw = x @ w
            x = x0 * xw[:, None] + bias[None, :] + x
        h = x0
        for w, bias in zip(self.mlp_w, self.mlp_b):
            h = torch.relu(h @ w + bias)
        return torch.cat([x, h], dim=-1) @ self.out_w + self.out_b

    @torch.no_grad()
    def load_jax_params(self, params: dict) -> "DCN":
        """Copy in the reference's parameter pytree (``init_dcn``'s layout:
        ``cross_w``/``cross_b`` lists, ``mlp`` list of ``{"w", "b"}``,
        ``out_w``, ``out_b``), leaves as numpy arrays."""
        def put(dst: torch.Tensor, src) -> None:
            src = torch.from_numpy(np.array(src, dtype=np.float32))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"parameter shape {tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)

        if len(params["cross_w"]) != len(self.cross_w) or len(params["mlp"]) != len(self.mlp_w):
            raise ValueError("parameter pytree depth does not match the DCNConfig")
        for dst, src in zip(self.cross_w, params["cross_w"]):
            put(dst, src)
        for dst, src in zip(self.cross_b, params["cross_b"]):
            put(dst, src)
        for w, b, layer in zip(self.mlp_w, self.mlp_b, params["mlp"]):
            put(w, layer["w"])
            put(b, layer["b"])
        put(self.out_w, params["out_w"])
        put(self.out_b, params["out_b"])
        return self

    @torch.no_grad()
    def jax_params(self) -> dict:
        """The parameters as the reference's pytree of numpy arrays."""
        def cpu(t):
            return t.detach().cpu().numpy()

        return {
            "cross_w": [cpu(t) for t in self.cross_w],
            "cross_b": [cpu(t) for t in self.cross_b],
            "mlp": [{"w": cpu(w), "b": cpu(b)} for w, b in zip(self.mlp_w, self.mlp_b)],
            "out_w": cpu(self.out_w),
            "out_b": cpu(self.out_b),
        }


@torch.no_grad()
def init_dcn(cfg: DCNConfig, generator: torch.Generator) -> DCN:
    """Random DCN on ``generator.device`` with the reference's distributions:
    cross weights N(0, 1/d0), MLP weights He-normal, output N(0, 1/fan_in),
    zero biases (``repro/models/ctr.py:33``; torch's stream, not JAX's)."""
    model = DCN(cfg, device=generator.device)

    def normal(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator, dtype=torch.float32,
                            device=generator.device) * std)

    d0 = cfg.input_dim
    for w in model.cross_w:
        normal(w, 1.0 / math.sqrt(d0))
    for w in model.mlp_w:
        normal(w, math.sqrt(2.0 / w.shape[0]))
    normal(model.out_w, 1.0 / math.sqrt(model.out_w.shape[0]))
    return model


def logits_from_rows(model: DCN, rows: torch.Tensor) -> torch.Tensor:
    """One entry point from looked-up rows [B, F, d] to logits [B], shared by
    serving (which reads the rows straight off the int8 codes) and, later,
    the trainer."""
    return model(rows)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits (numerically stable)."""
    return torch.mean(
        torch.clamp_min(logits, 0.0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
