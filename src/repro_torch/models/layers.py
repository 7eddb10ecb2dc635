"""Transformer building blocks: norms, RoPE / M-RoPE, GQA/SWA attention, SwiGLU
(port of repro/models/layers.py).

All functions are plain tensor code in the reference's layouts (activations
``[B, T, ...]``, weights ``[in, out]``).  Prefill attention is the reference's
flash formulation, forward only, through ``ops.flash_attention_fwd``: the
hand-written CUDA kernel on the card, its plain masked-softmax version on the
CPU.  Training attention (:func:`flash_attention_train`) is the reference's
pure-jnp ``flash_attention`` with its custom VJP, a ``torch.autograd.Function``
in plain PyTorch: an online-softmax forward over the key blocks each query
block's footprint touches, and a backward that keeps only ``(q, k, v, o,
lse)``.  Decode attention against the KV cache is plain PyTorch, as it is
plain jnp in the reference.  M-RoPE (:func:`mrope_angles`) serves the VLM,
the GELU MLP (:func:`gelu_mlp`) the encoder.  The reference's ``layer_norm``
has no caller (its hubert config takes RMSNorm) and is not ported.
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


def mrope_angles(positions3: torch.Tensor, head_dim: int, sections: tuple[int, int, int],
                 base: float = 10000.0):
    """Qwen2-VL M-RoPE: positions [3, B, T] (temporal, height, width) ->
    (cos, sin) [B, T, head_dim // 2], f32.  Frequency band j takes its
    position from the stream ``sections`` assigns it (the first
    ``sections[0]`` bands the temporal stream, and so on); with three equal
    streams this is :func:`rope_angles` bit for bit."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"sections {sections} must sum to head_dim//2={half}")
    freqs = _rope_freqs_on(head_dim, float(base), positions3.device)
    sec_id = torch.repeat_interleave(torch.arange(3, device=positions3.device),
                                     torch.tensor(sections, device=positions3.device))
    pos = positions3.index_select(0, sec_id)  # [half, B, T]
    ang = torch.movedim(pos, 0, -1).to(torch.float32) * freqs
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


def _block_mask(q_ids, k_ids, s: int, causal: bool, window: int | None) -> torch.Tensor:
    mask = (k_ids < s)[None, :]
    if causal:
        mask = mask & (q_ids[:, None] >= k_ids[None, :])
    if window is not None:
        mask = mask & (q_ids[:, None] - k_ids[None, :] < window)
    return mask


def _kv_range(q0: int, q1: int, s: int, causal: bool, window, k_block: int):
    """Key-block footprint ``[k_start, k_end)`` of query rows ``[q0, q1)``."""
    k_end = min(q1, s) if causal else s
    k_start = max(0, q0 - window + 1) if window is not None else 0
    return (k_start // k_block) * k_block, k_end


def _flash_train_fwd(q, k, v, causal, window, q_block, k_block, scale, s):
    """``(o [B, T, KH, G, D], lse [B, KH, G, T])`` over block-padded q/k/v;
    ``s`` is the unpadded key length (padding is masked)."""
    b, t, kh, g, d = q.shape
    out = torch.zeros((b, t, kh, g, d), dtype=q.dtype, device=q.device)
    lse = torch.zeros((b, kh, g, t), dtype=torch.float32, device=q.device)
    for q0 in range(0, t, q_block):
        q1 = q0 + q_block
        k_start, k_end = _kv_range(q0, q1, s, causal, window, k_block)
        if k_end <= k_start:
            continue
        q_blk = q[:, q0:q1].to(torch.float32) * scale
        q_ids = torch.arange(q0, q1, device=q.device)
        acc = torch.zeros((b, kh, g, q_block, d), dtype=torch.float32, device=q.device)
        m_run = torch.full((b, kh, g, q_block), -torch.inf, device=q.device)
        l_run = torch.zeros((b, kh, g, q_block), device=q.device)
        for ks in range(k_start, k_end, k_block):
            k_ids = ks + torch.arange(k_block, device=q.device)
            scores = torch.einsum("bqhgd,bkhd->bhgqk", q_blk,
                                  k[:, ks:ks + k_block].to(torch.float32))
            mask = _block_mask(q_ids, k_ids, s, causal, window)
            scores = torch.where(mask, scores, -torch.inf)
            m_new = torch.maximum(m_run, scores.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(mask, torch.exp(scores - m_safe[..., None]), 0.0)
            alpha = torch.where(torch.isfinite(m_run), torch.exp(m_run - m_safe), 0.0)
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v[:, ks:ks + k_block].to(torch.float32))
            m_run = m_new
        l_safe = torch.clamp_min(l_run, 1e-20)
        out[:, q0:q1] = torch.movedim(acc / l_safe[..., None], 3, 1).to(q.dtype)
        lse[..., q0:q1] = m_run + torch.log(l_safe)
    return out, lse


def _flash_train_bwd(q, k, v, o, lse, do, causal, window, q_block, k_block, scale, s, t_true):
    """``(dq, dk, dv)``: an outer loop over key blocks, an inner one over the
    query blocks that see them; dk / dv written once per key block."""
    b, t, kh, g, d = q.shape
    s_pad = k.shape[1]
    delta = torch.einsum("bthgd,bthgd->bhgt", do.to(torch.float32), o.to(torch.float32))
    dq = torch.zeros((b, t, kh, g, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, s_pad, kh, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for ks in range(0, s, k_block):
        ke = min(ks + k_block, s_pad)
        q_lo = ks if causal else 0
        q_hi = t_true if window is None else min(t_true, ke + window)
        if q_lo >= q_hi:
            continue
        k_blk = k[:, ks:ke].to(torch.float32)
        v_blk = v[:, ks:ke].to(torch.float32)
        k_ids = ks + torch.arange(ke - ks, device=q.device)
        dk_a = torch.zeros((b, ke - ks, kh, d), dtype=torch.float32, device=q.device)
        dv_a = torch.zeros_like(dk_a)
        for q0 in range((q_lo // q_block) * q_block, q_hi, q_block):
            q1 = q0 + q_block
            q_ids = torch.arange(q0, q1, device=q.device)
            qs = q[:, q0:q1].to(torch.float32) * scale
            scores = torch.einsum("bqhgd,bkhd->bhgqk", qs, k_blk)
            mask = _block_mask(q_ids, k_ids, s, causal, window)
            mask = mask & (q_ids < t_true)[:, None]
            p = torch.where(mask, torch.exp(scores - lse[..., q0:q1, None]), 0.0)
            do32 = do[:, q0:q1].to(torch.float32)
            dv_a = dv_a + torch.einsum("bhgqk,bqhgd->bkhd", p, do32)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", do32, v_blk)
            ds = p * (dp - delta[..., q0:q1, None])
            dq[:, q0:q1] += torch.einsum("bhgqk,bkhd->bqhgd", ds, k_blk) * scale
            dk_a = dk_a + torch.einsum("bhgqk,bqhgd->bkhd", ds, qs)
        dk[:, ks:ke] = dk_a
        dv[:, ks:ke] = dv_a
    return dq, dk, dv


class _FlashTrain(torch.autograd.Function):
    """The reference's ``_flash_core`` custom VJP: residuals ``(q, k, v, o,
    lse)``, O(T*D), never the [T, S] probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_block, k_block, scale, s, t_true):
        o, lse = _flash_train_fwd(q, k, v, causal, window, q_block, k_block, scale, s)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, q_block, k_block, scale, s, t_true)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_train_bwd(q, k, v, o, lse, do, *ctx.args)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), *(None,) * 7)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int | None = None,
                          q_block: int = 512, k_block: int = 1024,
                          softmax_scale: float | None = None) -> torch.Tensor:
    """Differentiable attention q [B, T, H, D], k/v [B, S, KH, D] -> [B, T, H, D]
    (GQA, causal, sliding window; port of the reference's ``flash_attention``).

    Plain PyTorch, not a kernel (the reference's is plain jnp too), and it
    never calls ``ops.flash_attention_fwd``.  T and S are padded up to the
    query / key blocks, and the masks neutralise the padding.  The
    reference's ``q_offset`` (prefill continuation) is not taken: training
    attends from position 0.
    """
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    q_block, k_block = min(q_block, t), min(k_block, s)
    t_pad, s_pad = -(-t // q_block) * q_block, -(-s // k_block) * k_block
    qg = F.pad(q.reshape(b, t, kh, h // kh, d), (0, 0, 0, 0, 0, 0, 0, t_pad - t))
    k = F.pad(k, (0, 0, 0, 0, 0, s_pad - s))
    v = F.pad(v, (0, 0, 0, 0, 0, s_pad - s))
    o = _FlashTrain.apply(qg, k, v, causal, window, q_block, k_block, scale, s, t)
    return o[:, :t].reshape(b, t, h, d)


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


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor, w_out: torch.Tensor,
             b_out: torch.Tensor, reduce=None) -> torch.Tensor:
    """Encoder MLP: out( gelu(x @ in + b_in) ) + b_out, with ``jax.nn.gelu``'s
    default, the tanh approximation; ``reduce`` (a model shard's all-reduce)
    goes between the out-projection and its bias."""
    out = F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out
    return (out if reduce is None else reduce(out)) + b_out


# ----------------------------------------------------------------- init


def dense_init(generator: torch.Generator, shape: tuple[int, ...], fan_in: int | None = None,
               dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in) weights on the generator's device."""
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
    return (w / math.sqrt(fan_in)).to(dtype)
