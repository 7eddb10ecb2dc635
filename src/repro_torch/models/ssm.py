"""Mamba2 (state-space duality / SSD) blocks, arXiv:2405.21060 (port of
repro/models/ssm.py).

Chunked SSD for training and prefill (a Python loop over the chunks carries
the inter-chunk state, where the reference scans with ``lax.scan``), the
recurrent form for decode (O(1) state per token).  The mixer's input
projection is split per stream (z, x, B, C, dt) as in the reference, so a
reference state crosses over leaf for leaf.  Shapes: d_inner = expand *
d_model, H = d_inner / headdim heads, state N, B/C shared across heads
(ngroups = 1).  Everything here is plain PyTorch: the reference's SSD is
plain jnp, outside any Pallas kernel.

One deliberate deviation (ROADMAP Queue C): the intra-chunk decay is
``exp(where(mask, seg, -inf))``, where the reference takes ``where(mask,
exp(seg), 0)``.  On the masked upper triangle ``seg`` sums |dt A| over up to
a chunk of steps; at mamba2-370m's width (32 heads, A down to -32, chunks of
128) it passes 88 and ``exp`` overflows to inf.  The forward picks 0 there
either way, so the values are the same; but the reference's backward then
multiplies a zero cotangent by inf, and the gradients of ``A_log``,
``dt_bias``, ``wdt`` and the input come out NaN.  Masking before the
exponential keeps them finite and equal to the reference's wherever those
are finite (tests/test_torch_ssm_moe.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.dist import tensor_parallel as tp
from repro_torch.models.layers import rms_norm


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:  # total conv channels (x | B | C)
        return self.d_inner + 2 * self.d_state

    @property
    def proj_width(self) -> int:  # total input-projection columns
        return 2 * self.d_inner + 2 * self.d_state + self.n_heads


def init_ssm(generator: torch.Generator, cfg: SSMConfig, dtype=torch.float32) -> dict[str, Any]:
    """The mixer's params drawn from ``generator`` on its device, in the
    reference's layout and scales (the draws are torch's)."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    dev = generator.device

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev) * scale).to(dtype)

    s = 1.0 / math.sqrt(d)
    u = torch.rand((h,), generator=generator, device=dev)
    dt_init = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min)) + math.log(cfg.dt_min))
    return {
        "wz": normal((d, di), s),
        "wx": normal((d, di), s),
        "wB": normal((d, n), s),
        "wC": normal((d, n), s),
        "wdt": normal((d, h), s),
        # Depthwise causal conv over (x | B | C), stored per stream.
        "conv_x": normal((cfg.conv_width, di), 0.1),
        "conv_B": torch.full((cfg.conv_width, n), 0.1, dtype=dtype, device=dev),
        "conv_C": torch.full((cfg.conv_width, n), 0.1, dtype=dtype, device=dev),
        "conv_bx": torch.zeros((di,), dtype=dtype, device=dev),
        "conv_bB": torch.zeros((n,), dtype=dtype, device=dev),
        "conv_bC": torch.zeros((n,), dtype=dtype, device=dev),
        # softplus(dt_bias) spans [dt_min, dt_max] (mamba2 init).
        "dt_bias": torch.log(torch.expm1(dt_init)),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=dev)),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm_w": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": normal((di, d), 1.0 / math.sqrt(di)),
    }


def param_shapes(cfg: SSMConfig) -> dict[str, tuple[int, ...]]:
    """The whole shapes of :func:`init_ssm`'s leaves."""
    d, di, n, h, w = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.conv_width
    return {"wz": (d, di), "wx": (d, di), "wB": (d, n), "wC": (d, n), "wdt": (d, h),
            "conv_x": (w, di), "conv_B": (w, n), "conv_C": (w, n), "conv_bx": (di,),
            "conv_bB": (n,), "conv_bC": (n,), "dt_bias": (h,), "A_log": (h,), "D": (h,),
            "norm_w": (di,), "out_proj": (di, d)}


def _gated_norm(v: torch.Tensor, w: torch.Tensor, width: int, eps: float = 1e-6):
    """``rms_norm`` over the whole ``width`` (``d_inner``) of ``v``: a model
    shard's block of it takes the mean of squares over every rank's block
    (:func:`~repro_torch.dist.tensor_parallel.sum_over_model`, whose
    backward sums too: every rank's output reads it)."""
    if v.shape[-1] == width:
        return rms_norm(v, w, eps)
    v32 = v.to(torch.float32)
    var = tp.sum_over_model(torch.sum(torch.square(v32), dim=-1, keepdim=True)) / width
    return ((v32 * torch.rsqrt(var + eps)) * w.to(torch.float32)).to(v.dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: out_t = silu(b + sum_i w[i] * x_{t-W+1+i})."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i: i + x.shape[1], :] * w[i]
    return F.silu(out + b)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
                C_: torch.Tensor, chunk: int, ssm_state: torch.Tensor | None = None):
    """x [B, T, H, P], dt [B, T, H] (post-softplus), A [H] (negative), B_ / C_
    [B, T, N], ``ssm_state`` [B, H, P, N] -> (y [B, T, H, P], final state)."""
    b, t, h, p = x.shape
    n = B_.shape[-1]
    if t % chunk:
        raise ValueError(f"seq {t} must divide chunk {chunk}")
    nc, q = t // chunk, chunk
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc = B_.reshape(b, nc, q, n).to(torch.float32)
    Cc = C_.reshape(b, nc, q, n).to(torch.float32)
    cs = torch.cumsum(dtc * A, dim=2)  # within-chunk cumulative log decay (negative)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if ssm_state is None else ssm_state.to(torch.float32))
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))[None, :, :, None]
    ys = []
    for ci in range(nc):
        xq, dtq, Bq, Cq, csq = xc[:, ci], dtc[:, ci], Bc[:, ci], Cc[:, ci], cs[:, ci]
        xdt = (xq * dtq[..., None]).to(torch.float32)  # [b, q, h, p]
        # Intra: Y[i] = sum_{j<=i} (C_i.B_j) * exp(cs_i - cs_j) * xdt_j, the
        # upper triangle masked before the exponential (the module's note).
        cb = torch.einsum("bin,bjn->bij", Cq, Bq)
        seg = csq[:, :, None, :] - csq[:, None, :, :]  # [b, i, j, h]
        decay = torch.exp(torch.where(mask, seg, -math.inf))
        y_intra = torch.einsum("bijh,bjhp->bihp", cb[..., None] * decay, xdt)
        # Inter: Y[i] += C_i . state * exp(cs_i)
        y_inter = torch.einsum("bin,bhpn->bihp", Cq, state) * torch.exp(csq)[..., None]
        # State: S' = exp(total) * S + sum_j exp(cs_end - cs_j) B_j (x) xdt_j
        total = csq[:, -1, :]  # [b, h]
        decay_to_end = torch.exp(total[:, None, :] - csq)  # [b, q, h]
        s_local = torch.einsum("bjhp,bjn->bhpn", decay_to_end[..., None] * xdt, Bq)
        state = torch.exp(total)[:, :, None, None] * state + s_local
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.stack(ys, dim=1).reshape(b, t, h, p), state


def _project(params, u):
    """Split projections: u [B, T, d] -> z, x_raw, B_raw, C_raw, dt_raw."""
    return (u @ params["wz"], u @ params["wx"], u @ params["wB"], u @ params["wC"],
            u @ params["wdt"])


def check_prefill_len(cfg: SSMConfig, t: int) -> None:
    """Raise ``ValueError`` for a sequence the chunked SSD cannot take whole:
    longer than a chunk and not a multiple of it (padding would run the
    state through the pad tokens), or, where a decode cache is built, shorter
    than its conv window (``conv_width - 1`` tokens)."""
    chunk = min(cfg.chunk, t)
    if t % chunk:
        raise ValueError(f"seq {t} must divide chunk {chunk}: an SSM prompt longer than "
                         f"{cfg.chunk} tokens must be a multiple of {cfg.chunk}")
    if t < cfg.conv_width - 1:
        raise ValueError(f"seq {t} is shorter than the conv window's {cfg.conv_width - 1} "
                         "tokens the decode cache holds")


def ssm_forward(params: dict[str, Any], u: torch.Tensor, cfg: SSMConfig,
                ssm_state: torch.Tensor | None = None, return_cache: bool = False):
    """The full mamba2 mixer over u [B, T, d_model] -> ``(out, cache | None)``;
    the cache (``return_cache``) holds the last ``conv_width - 1`` raw conv
    inputs per stream and the final SSD state.  ``params`` may be a model
    shard's (``transformer._mamba_block``): its heads and its block of
    ``d_inner``, ``out`` then this rank's partial sum."""
    b, t, _ = u.shape
    if return_cache:
        check_prefill_len(cfg, t)
    z, x_raw, B_raw, C_raw, dt_raw = _project(params, u)
    x = _causal_conv(x_raw, params["conv_x"], params["conv_bx"])
    B_ = _causal_conv(B_raw, params["conv_B"], params["conv_bB"])
    C_ = _causal_conv(C_raw, params["conv_C"], params["conv_bC"])
    x = x.reshape(b, t, -1, cfg.headdim)
    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, state = ssd_chunked(x, dt, A, B_, C_, min(cfg.chunk, t), ssm_state)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * x
    y = _gated_norm(y.reshape(b, t, -1) * F.silu(z), params["norm_w"], cfg.d_inner)
    out = y @ params["out_proj"]
    if not return_cache:
        return out, None
    w = cfg.conv_width - 1
    cache = {"conv_x": x_raw[:, t - w:].to(u.dtype), "conv_B": B_raw[:, t - w:].to(u.dtype),
             "conv_C": C_raw[:, t - w:].to(u.dtype), "ssm": state}
    return out, cache


def _conv_step(window: torch.Tensor, new: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """One causal-conv step: window [B, W-1, c] + new [B, c] -> (out, window')."""
    full = torch.cat([window, new[:, None, :]], dim=1)  # [B, W, c]
    out = F.silu(torch.einsum("bwc,wc->bc", full, w) + b)
    return out, full[:, 1:]


def ssm_decode_step(params: dict[str, Any], u: torch.Tensor, cfg: SSMConfig,
                    cache: dict[str, torch.Tensor]):
    """The O(1) recurrent step over u [B, 1, d_model] -> ``(out [B, 1, d],
    new_cache)`` (new tensors; ``cache`` is left as it is)."""
    b = u.shape[0]
    z, x_raw, B_raw, C_raw, dt_raw = _project(params, u)
    x1, conv_x = _conv_step(cache["conv_x"], x_raw[:, 0], params["conv_x"], params["conv_bx"])
    B1, conv_B = _conv_step(cache["conv_B"], B_raw[:, 0], params["conv_B"], params["conv_bB"])
    C1, conv_C = _conv_step(cache["conv_C"], C_raw[:, 0], params["conv_C"], params["conv_bC"])
    x = x1.reshape(b, cfg.n_heads, cfg.headdim)
    dt1 = F.softplus(dt_raw[:, 0].to(torch.float32) + params["dt_bias"])
    a = torch.exp(dt1 * -torch.exp(params["A_log"]))  # [B, H]
    xdt = (x * dt1[..., None]).to(torch.float32)
    new_state = a[:, :, None, None] * cache["ssm"] + torch.einsum(
        "bn,bhp->bhpn", B1.to(torch.float32), xdt)
    y = torch.einsum("bn,bhpn->bhp", C1.to(torch.float32), new_state)
    y = y.to(u.dtype) + params["D"].to(u.dtype)[None, :, None] * x
    y = rms_norm(y.reshape(b, 1, cfg.d_inner) * F.silu(z), params["norm_w"])
    new_cache = {"conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C, "ssm": new_state}
    return y @ params["out_proj"], new_cache


def init_ssm_cache(cfg: SSMConfig, batch: int, dtype=torch.float32,
                   device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    w = cfg.conv_width - 1
    return {
        "conv_x": torch.zeros((batch, w, cfg.d_inner), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, w, cfg.d_state), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, w, cfg.d_state), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.headdim, cfg.d_state), dtype=torch.float32,
                           device=device),
    }
