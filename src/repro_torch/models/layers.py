"""Transformer building blocks: norms, RoPE, GQA/SWA attention, SwiGLU
(port of repro/models/layers.py).

All functions are plain tensor code in the reference's layouts (activations
``[B, T, ...]``, weights ``[in, out]``).  Prefill attention is the reference's
flash formulation, forward only, through ``ops.flash_attention_fwd``: the
hand-written CUDA kernel on the card, its plain masked-softmax version on the
CPU.  Decode attention against the KV cache is plain PyTorch, as it is plain
jnp in the reference.  M-RoPE, LayerNorm and the GELU MLP come with the
architectures that use them.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

# ----------------------------------------------------------------- norms


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * w.to(torch.float32)).to(dtype)


# ----------------------------------------------------------------- RoPE


@functools.lru_cache(maxsize=16)
def _rope_freqs(head_dim: int, base: float) -> np.ndarray:
    """``base ** (-arange(half) / half)`` in float32 as the jitted reference
    computes it: XLA:CPU divides by the constant ``half`` as a multiply by
    its float32 reciprocal, and its ``pow`` is the C library's ``powf``,
    which numpy's float32 scalar power calls (torch's float32 ``pow`` and a
    true division each differ by an ulp on some exponents, e.g. at head_dim
    80)."""
    half = head_dim // 2
    expo = -np.arange(0, half, dtype=np.float32) * np.float32(1.0 / half)
    return np.array([np.float32(base) ** e for e in expo], dtype=np.float32)


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(head_dim: int, base: float, device: torch.device) -> torch.Tensor:
    """:func:`_rope_freqs` on ``device``, copied there once."""
    return torch.from_numpy(_rope_freqs(head_dim, base)).to(device)


def rope_angles(positions: torch.Tensor, head_dim: int, base: float = 10000.0):
    """positions [...] -> (cos, sin) of shape [..., head_dim // 2], f32."""
    freqs = _rope_freqs_on(head_dim, float(base), positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, D]; cos/sin [B, T, D//2] -> rotated x (split-half layout)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ----------------------------------------------------------------- attention


def pad_heads(n_heads: int, n_kv_heads: int, multiple: int) -> tuple[int, int]:
    """Pad head counts so q-heads shard over ``multiple`` and divide kv-heads
    -> ``(padded_q_heads, padded_kv_heads)`` (the reference's TP padding)."""
    h = n_heads
    if multiple > 1:
        h = ((n_heads + multiple - 1) // multiple) * multiple
    kv = n_kv_heads
    while h % kv != 0:
        kv += 1
    return h, kv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softmax_scale: float | None = None,
                    use_kernel: bool = True) -> torch.Tensor:
    """Full-sequence attention q [B, T, H, D], k/v [B, S, KH, D] -> [B, T, H, D]
    through ``ops.flash_attention_fwd`` (forward only: serving needs no VJP).

    The reference's ``q_offset`` (prefill continuation) and its
    ``q_block`` / ``k_block`` tiling knobs are not taken: the serving path
    prefills from position 0 and the kernel picks its own tiles.
    """
    return ops.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softmax_scale=softmax_scale, use_kernel=use_kernel)


def decode_mask(cache_len, s: int, b: int, *, window: int | None = None,
                device=None) -> torch.Tensor:
    """[B, S] bool: the cache slots a decode query attends to, from each
    slot's valid prefix length ``cache_len`` (int [] or [B])."""
    k_ids = torch.arange(s, device=device)
    cl = torch.as_tensor(cache_len, device=device)
    cl = cl[:, None] if cl.ndim == 1 else cl.reshape(1, 1)
    valid = k_ids[None, :] < cl  # [B or 1, S]
    if window is not None:
        valid &= k_ids[None, :] >= (cl - window)
    return valid.expand(b, s)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor | None, *, window: int | None = None,
                     softmax_scale: float | None = None,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """Single-token attention q [B, 1, H, D] against a KV cache [B, S, KH, D];
    ``cache_len`` int [] or [B] is each slot's valid prefix length.  A caller
    that attends many layers at one step passes ``decode_mask`` once as
    ``valid`` (``cache_len`` and ``window`` are then unused)."""
    b, _, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, kh, g, d).to(torch.float32) * scale
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.to(torch.float32))
    if valid is None:
        valid = decode_mask(cache_len, s, b, window=window, device=q.device)
    scores = torch.where(valid[:, None, None, :], scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.to(torch.float32))
    return o.reshape(b, 1, h, d).to(q.dtype)


# ----------------------------------------------------------------- MLPs


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """LLaMA-family MLP: down( silu(x @ gate) * (x @ up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# ----------------------------------------------------------------- init


def dense_init(generator: torch.Generator, shape: tuple[int, ...], fan_in: int | None = None,
               dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in) weights on the generator's device."""
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
    return (w / math.sqrt(fan_in)).to(dtype)
