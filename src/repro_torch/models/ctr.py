"""CTR backbones: DCN (paper §4.1, Wang et al. 2017) and DeepFM (Guo et al.
2017), port of repro/models/ctr.py.

The model takes already-looked-up embedding rows [B, F, d], so the same
forward serves every embedding method.  Parameters keep the reference's
layout — an MLP weight is ``[in, out]`` and applied as ``h @ w`` — so
:meth:`DCN.load_jax_params` / :meth:`DCN.jax_params` move them across
without a transpose.  The matmuls are plain PyTorch, as they are plain XLA
in the reference; entry points turn TF32 off (:mod:`repro_torch.device`).

Paper Appendix B: DCN with cross/deep depth 3 (widths 1024/512/256) for
Avazu, depth 5 (width 1000) and dropout 0.2 on the MLP for Criteo.  Dropout
masks are an operand of the forward (``masks``: one bool keep-mask per MLP
layer, drawn by :func:`dropout_masks` from a generator, or the reference's
``bernoulli`` draws in a test); without masks the forward is the inference
forward.  DeepFM reads a [B, F, d + 1] lookup whose last column is the
first-order weight.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ref


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

    def forward(self, rows: torch.Tensor, masks=None) -> torch.Tensor:
        """Logits [B] from embedding rows [B, F, d]; ``masks``: the MLP's
        dropout keep-masks (training with ``cfg.dropout`` > 0), else None."""
        b = rows.shape[0]
        x0 = rows.reshape(b, -1)
        # Cross network: x_{l+1} = x0 * (x_l . w_l) + b_l + x_l
        x = x0
        for w, bias in zip(self.cross_w, self.cross_b):
            xw = x @ w
            x = x0 * xw[:, None] + bias[None, :] + x
        h = _mlp(x0, self.mlp_w, self.mlp_b, self.cfg.dropout, masks)
        return torch.cat([x, h], dim=-1) @ self.out_w + self.out_b

    @torch.no_grad()
    def load_jax_params(self, params: dict) -> "DCN":
        """Copy in the reference's parameter pytree (``init_dcn``'s layout:
        ``cross_w``/``cross_b`` lists, ``mlp`` list of ``{"w", "b"}``,
        ``out_w``, ``out_b``), leaves numpy arrays or tensors."""
        if len(params["cross_w"]) != len(self.cross_w) or len(params["mlp"]) != len(self.mlp_w):
            raise ValueError("parameter pytree depth does not match the DCNConfig")
        for dst, src in zip(self.cross_w, params["cross_w"]):
            _put(dst, src)
        for dst, src in zip(self.cross_b, params["cross_b"]):
            _put(dst, src)
        for w, b, layer in zip(self.mlp_w, self.mlp_b, params["mlp"]):
            _put(w, layer["w"])
            _put(b, layer["b"])
        _put(self.out_w, params["out_w"])
        _put(self.out_b, params["out_b"])
        return self

    def param_tree(self) -> dict:
        """The parameters themselves in the reference's pytree layout."""
        return {
            "cross_w": list(self.cross_w),
            "cross_b": list(self.cross_b),
            "mlp": [{"w": w, "b": b} for w, b in zip(self.mlp_w, self.mlp_b)],
            "out_w": self.out_w,
            "out_b": self.out_b,
        }

    def jax_params(self) -> dict:
        """The parameters as the reference's pytree of numpy arrays."""
        return _numpy_tree(self.param_tree())


def _mlp(h, ws, bs, dropout: float, masks) -> torch.Tensor:
    """ReLU layers ``h @ w + b``; with ``masks`` (one bool [B, width] keep-mask
    per layer) inverted dropout after each, ``where(keep, h / (1 - p), 0)``."""
    keep_p = ref.f32(1.0 - dropout)
    for i, (w, bias) in enumerate(zip(ws, bs)):
        h = torch.relu(h @ w + bias)
        if dropout > 0.0 and masks is not None:
            h = torch.where(masks[i], h / ref.scalar(keep_p, h), 0.0)
    return h


def dropout_masks(cfg, generator: torch.Generator, batch: int) -> list | None:
    """The MLP's keep-masks for one training forward of ``batch`` rows: bool
    [batch, width] per layer, ``uniform < 1 - p`` (the reference's
    ``bernoulli``) from ``generator``; None when ``cfg.dropout`` is 0."""
    if not cfg.dropout > 0.0:
        return None
    keep_p = ref.f32(1.0 - cfg.dropout)
    return [torch.rand((batch, w), generator=generator, dtype=torch.float32,
                       device=generator.device) < keep_p for w in cfg.mlp_widths]


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


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    n_fields: int
    emb_dim: int  # the FM / deep width; the table is emb_dim + 1 wide
    mlp_widths: tuple[int, ...] = (400, 400, 400)
    dropout: float = 0.0

    @property
    def input_dim(self) -> int:
        return self.n_fields * self.emb_dim


class DeepFM(nn.Module):
    """DeepFM: FM first and second order beside an MLP over the shared rows."""

    def __init__(self, cfg: DeepFMConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        widths = (cfg.input_dim, *cfg.mlp_widths)
        self.mlp_w = nn.ParameterList([
            nn.Parameter(torch.zeros(i, o, dtype=torch.float32, device=device))
            for i, o in zip(widths[:-1], widths[1:])
        ])
        self.mlp_b = nn.ParameterList([
            nn.Parameter(torch.zeros(o, dtype=torch.float32, device=device))
            for o in cfg.mlp_widths])
        self.out_w = nn.Parameter(torch.zeros(widths[-1], dtype=torch.float32, device=device))
        self.out_b = nn.Parameter(torch.zeros((), dtype=torch.float32, device=device))

    def forward(self, rows: torch.Tensor, masks=None) -> torch.Tensor:
        """Logits [B] from rows [B, F, d + 1]: the last column is the
        first-order weight, the rest the shared FM / deep embedding."""
        r, first = rows[..., :-1], rows[..., -1]
        b = r.shape[0]
        # FM second order: 0.5 * ((sum v)^2 - sum v^2).
        s = r.sum(dim=1)
        fm2 = 0.5 * ((s * s).sum(dim=-1) - (r * r).sum(dim=(1, 2)))
        fm1 = first.sum(dim=1)
        h = _mlp(r.reshape(b, -1), self.mlp_w, self.mlp_b, self.cfg.dropout, masks)
        return fm1 + fm2 + (h @ self.out_w + self.out_b)

    @torch.no_grad()
    def load_jax_params(self, params: dict) -> "DeepFM":
        """Copy in the reference's pytree (``init_deepfm``'s layout: ``mlp``
        list of ``{"w", "b"}``, ``out_w``, ``out_b``), numpy or tensor leaves."""
        if len(params["mlp"]) != len(self.mlp_w):
            raise ValueError("parameter pytree depth does not match the DeepFMConfig")
        for w, b, layer in zip(self.mlp_w, self.mlp_b, params["mlp"]):
            _put(w, layer["w"])
            _put(b, layer["b"])
        _put(self.out_w, params["out_w"])
        _put(self.out_b, params["out_b"])
        return self

    def param_tree(self) -> dict:
        return {"mlp": [{"w": w, "b": b} for w, b in zip(self.mlp_w, self.mlp_b)],
                "out_w": self.out_w, "out_b": self.out_b}

    def jax_params(self) -> dict:
        return _numpy_tree(self.param_tree())


def params_like(module: nn.Module, tensors) -> dict:
    """``tensors`` (in ``module.parameters()`` order: an Adam moment, say) in
    the module's reference pytree layout (its ``param_tree``)."""
    pos = {id(p): i for i, p in enumerate(module.parameters())}

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, list):
            return [put(v) for v in x]
        return tensors[pos[id(x)]]

    return put(module.param_tree())


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.detach().cpu().numpy()


def _put(dst: torch.Tensor, src) -> None:
    """Copy ``src`` (a numpy array or a tensor on any device) into ``dst``."""
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.array(src, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"parameter shape {tuple(src.shape)} != {tuple(dst.shape)}")
    dst.copy_(src)


@torch.no_grad()
def init_deepfm(cfg: DeepFMConfig, generator: torch.Generator) -> DeepFM:
    """Random DeepFM on ``generator.device`` with the reference's
    distributions: He-normal MLP weights, output N(0, 1/fan_in), zero biases
    (``repro/models/ctr.py:99``; torch's stream, not JAX's)."""
    model = DeepFM(cfg, device=generator.device)
    for w in model.mlp_w:
        w.copy_(torch.randn(w.shape, generator=generator, dtype=torch.float32,
                            device=generator.device) * math.sqrt(2.0 / w.shape[0]))
    n = model.out_w.shape[0]
    model.out_w.copy_(torch.randn((n,), generator=generator, dtype=torch.float32,
                                  device=generator.device) / math.sqrt(n))
    return model


#: Backbone name -> (config class, module, init).
MODELS = {"dcn": (DCNConfig, DCN, init_dcn), "deepfm": (DeepFMConfig, DeepFM, init_deepfm)}


def logits_from_rows(model: nn.Module, rows: torch.Tensor, masks=None) -> torch.Tensor:
    """One entry point from looked-up rows to logits [B] for every backbone
    (DCN: [B, F, d]; DeepFM: [B, F, d + 1]), shared by serving, which reads
    the rows straight off the codes, and the trainer, which passes the
    step's dropout ``masks``."""
    return model(rows, masks)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits (numerically stable)."""
    return torch.mean(
        torch.clamp_min(logits, 0.0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
