"""CUDA ``flash_attention_fwd``: fused online-softmax attention forward.

Port of ``repro/kernels/flash_attention.py:88``; the kernel is in
``csrc/flash_attention.cu``, whose header says what bounds it and how it is
built for that.  q [B, T, H, D], k/v [B, S, KH, D] in fp32 -> [B, T, H, D],
with GQA (query head h reads kv head h // (H / KH)), an optional causal mask
and sliding window, and ragged T and S masked as the Pallas kernel masks
them.  The kernel picks its own tiles: a block holds 16 queries of up to 8
query heads of one kv head and walks 32-key tiles; when those blocks are too
few to fill the card (short prompts), up to 5 warp groups in each block
share the query tile's kv tiles and merge their partial (o, max, sum) in
shared memory.  The reference config's ``attn_q_block`` /
``attn_k_block`` are TPU tiling knobs and are not read.  Both products run
on the tensor cores as 3xTF32 (fp32 accuracy); against the plain version
in :mod:`repro_torch.kernels.ref` (one masked softmax over all keys) it
agrees within fp32 rounding of the online rescaling and the sums in
another order.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 128


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softmax_scale: float | None = None) -> torch.Tensor:
    """Attention forward on one CUDA device; raises on shapes or dtypes the
    kernel does not take (D a multiple of 8 up to 128, fp32, H % KH == 0)."""
    kernel = "flash_attention_fwd"
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"{kernel}: q and k must be 4-D, got {tuple(q.shape)}, {tuple(k.shape)}")
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: head dim must be a multiple of 8 up to {MAX_HEAD_DIM}, "
                         f"got {d}")
    if kh < 1 or h % kh:
        raise ValueError(f"{kernel}: {h} query heads do not group over {kh} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"{kernel}: window must be >= 1, got {window}")
    _build.check_operand(kernel, "q", q, torch.float32, (b, t, h, d))
    _build.check_operand(kernel, "k", k, torch.float32, (b, s, kh, d), q.device)
    _build.check_operand(kernel, "v", v, torch.float32, (b, s, kh, d), q.device)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{kernel}: q, k and v must start on 16-byte boundaries (float4 loads)")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with _build.on_device(q.device):
        _build.launch(
            kernel, "flash_attention", "flash_attention_fwd_launch",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, s, h, kh, d,
            int(causal), 0 if window is None else int(window), scale,
            _build.stream_of(q.device),
        )
    return out
