"""The unified LM backbone (port of repro/models/transformer.py): dense
llama-family stacks, Mamba2 (SSD) mixers, routed MoE with shared experts,
hybrid period patterns (Jamba), the encoder (HuBERT) and the VLM (Qwen2-VL).

GQA attention with optional QK-RMSNorm, QKV bias, M-RoPE (positions [3, B,
T], ``layers.mrope_angles``) and a sliding window (a window-sized ring
buffer at decode), non-causal attention (the encoder), SwiGLU or GELU
MLPs or MoE layers (:mod:`repro_torch.models.moe`, whose load-balance loss
:func:`backbone` sums), mamba mixers (:mod:`repro_torch.models.ssm`; a
pure-mamba block with ``d_ff == 0`` has no MLP and no ``norm2``), a tied or
untied head.  Input modes (:func:`assemble_embeds`): ``tokens``; ``embeds``
(the encoder's precomputed frames, the table not read); ``mixed``, which
puts ``prefix_embeds`` in the first ``visual_prefix`` positions in
training, while serving runs the text path, three equal position streams.
``remat`` recomputes each group's forward in the backward
(``torch.utils.checkpoint``, bitwise the step without it).

Parameters are plain dicts of tensors in the reference's layout, so a
reference state crosses over leaf for leaf (``repro_torch.interop``):
``blocks`` is a list over the period positions, each leaf stacked
``[n_groups, ...]``; weights are ``[in, out]``.  A Python loop over the
groups replaces ``lax.scan``.  The decode cache has the same layout: per
period position, ``{"k", "v"}`` ``[n_groups, B, kv_len, KH, D]`` for an
attention layer or the SSM cache ``{"conv_x", "conv_B", "conv_C", "ssm"}``
``[n_groups, B, ...]`` for a mamba layer.

The embedding table is not in the params: it is a serving table
(``repro_torch.serving.table``) passed to the forward.  An int8-resident
``QuantTable`` reads token rows through ``ops.dequant_gather`` and, for a
tied head, contracts the logits through ``ops.dequant_matmul``: the fp32
table never exists.  Prefill attention runs ``ops.flash_attention_fwd``.

Training (:func:`loss_fn`) reads a dense fp32 [V, d] table, as the
reference's training step does: the embedding is a plain index into it, the
tied head a plain fp32 matmul, attention the differentiable
``layers.flash_attention_train``, and the cross-entropy is taken over chunks
of the sequence (:func:`chunked_ce_loss`), each recomputed in the backward.
Under a sharding context (:mod:`repro_torch.dist`) the same code runs on a
rank's shards: the collectives of :mod:`repro_torch.dist.tensor_parallel`
sit where the reference's ``hint`` calls do, and are the identity without
a context.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import device as device_mod
from repro_torch.dist import context as dist_ctx
from repro_torch.dist import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.optim import tree_leaves
from repro_torch.serving import table as serving_tbl


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    # Period pattern: layer l has type layer_types[l % period].
    layer_types: tuple[str, ...] = ("attn",)  # 'attn' | 'mamba'
    moe_pattern: tuple[bool, ...] = (False,)  # per period position: routed MoE?
    moe: moe_mod.MoEConfig | None = None
    ssm: ssm_mod.SSMConfig | None = None
    # Attention flavor.
    qk_norm: bool = False
    attn_bias: bool = False
    sliding_window: int | None = None
    rope_base: float = 10000.0
    mrope_sections: tuple[int, int, int] | None = None
    causal: bool = True  # False -> encoder-only (hubert)
    mlp_type: str = "swiglu"  # 'swiglu' | 'gelu' (hubert) — d_ff == 0: no MLP
    # Embedding / head (the paper's technique lives here).
    embedding_method: str = "alpt"  # 'fp' | 'lpt' | 'alpt'
    embedding_bits: int = 8
    tie_embeddings: bool = False
    input_mode: str = "tokens"  # 'tokens' | 'embeds' | 'mixed'
    visual_prefix: int = 0  # 'mixed': number of patch-embedding positions
    # Numerics / sharding-shape knobs.
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    head_pad_multiple: int = 1  # pad q-heads to a multiple (16 for TP dry-run)
    ce_chunk: int = 512
    attn_q_block: int = 512  # TPU tiling knob; the CUDA kernel picks its own tiles
    attn_k_block: int = 1024  # TPU tiling knob; the CUDA kernel picks its own tiles
    remat: bool = False  # checkpoint each period group in the scan

    @property
    def period(self) -> int:
        return len(self.layer_types)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.period == 0, (self.n_layers, self.period)
        return self.n_layers // self.period

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_heads(self) -> tuple[int, int]:
        return L.pad_heads(self.n_heads, self.n_kv_heads, self.head_pad_multiple)

    def layer_type(self, pos: int) -> str:
        return self.layer_types[pos % self.period]

    def is_moe(self, pos: int) -> bool:
        return self.moe_pattern[pos % self.period] if self.moe is not None else False


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a malformed config: an unknown input mode,
    MLP type or layer type, or mamba layers without an SSM config."""
    if cfg.input_mode not in ("tokens", "embeds", "mixed"):
        raise ValueError(f"{cfg.name}: unknown input_mode {cfg.input_mode!r}")
    if cfg.mlp_type not in ("swiglu", "gelu"):
        raise ValueError(f"{cfg.name}: unknown mlp_type {cfg.mlp_type!r}")
    for kind in cfg.layer_types:
        if kind not in ("attn", "mamba"):
            raise ValueError(f"{cfg.name}: unknown layer type {kind!r}")
    if "mamba" in cfg.layer_types and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: mamba layers need an SSMConfig")


def _has_attention(cfg: ModelConfig) -> bool:
    return "attn" in cfg.layer_types


def _has_mamba(cfg: ModelConfig) -> bool:
    return "mamba" in cfg.layer_types


def rope_of(positions: torch.Tensor, cfg: ModelConfig):
    """``(cos, sin)`` [B, T, hd // 2] of ``positions``: M-RoPE of [3, B, T]
    streams where ``cfg.mrope_sections`` is set, else RoPE of [B, T]."""
    if cfg.mrope_sections is not None:
        return L.mrope_angles(positions, cfg.hd, cfg.mrope_sections, cfg.rope_base)
    return L.rope_angles(positions, cfg.hd, cfg.rope_base)


# --------------------------------------------------------------------- init


def _init_attn(g: torch.Generator, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    h, kv = cfg.padded_heads
    hd, d, dt = cfg.hd, cfg.d_model, cfg.param_dtype
    p = {
        "wq": L.dense_init(g, (d, h * hd), dtype=dt),
        "wk": L.dense_init(g, (d, kv * hd), dtype=dt),
        "wv": L.dense_init(g, (d, kv * hd), dtype=dt),
        "wo": L.dense_init(g, (h * hd, d), dtype=dt),
    }
    if cfg.attn_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros((width,), dtype=dt, device=g.device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=g.device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=g.device)
    return p


def _attn_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The whole shapes of one layer's attention leaves (:func:`_init_attn`)."""
    h, kv = cfg.padded_heads
    hd, d = cfg.hd, cfg.d_model
    return {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d),
            "bq": (h * hd,), "bk": (kv * hd,), "bv": (kv * hd,), "q_norm": (hd,),
            "k_norm": (hd,)}


def _block_keys(cfg: ModelConfig, pos: int) -> set[str]:
    """The keys of the block at period position ``pos``: its norms, its mixer
    and its MLP or MoE (a pure-mamba block with ``d_ff == 0`` has neither, and
    no ``norm2``)."""
    keys = {"norm1", "attn" if cfg.layer_type(pos) == "attn" else "mamba"}
    if cfg.is_moe(pos):
        keys |= {"norm2", "moe"}
    elif cfg.d_ff > 0:
        keys |= {"norm2", "mlp"}
    return keys


def _init_block(g: torch.Generator, cfg: ModelConfig, pos: int) -> dict[str, Any]:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    p: dict[str, Any] = {"norm1": torch.ones((d,), dtype=dt, device=g.device)}
    if cfg.layer_type(pos) == "attn":
        p["attn"] = _init_attn(g, cfg)
    else:
        p["mamba"] = ssm_mod.init_ssm(g, cfg.ssm, dtype=dt)
    if cfg.is_moe(pos) or f > 0:
        p["norm2"] = torch.ones((d,), dtype=dt, device=g.device)
    if cfg.is_moe(pos):
        p["moe"] = moe_mod.init_moe(g, cfg.moe, dtype=dt)
    elif f > 0 and cfg.mlp_type == "gelu":
        p["mlp"] = {"w_in": L.dense_init(g, (d, f), dtype=dt),
                    "b_in": torch.zeros((f,), dtype=dt, device=g.device),
                    "w_out": L.dense_init(g, (f, d), dtype=dt),
                    "b_out": torch.zeros((d,), dtype=dt, device=g.device)}
    elif f > 0:
        p["mlp"] = {"w_gate": L.dense_init(g, (d, f), dtype=dt),
                    "w_up": L.dense_init(g, (d, f), dtype=dt),
                    "w_down": L.dense_init(g, (f, d), dtype=dt)}
    return p


def _stacked_blocks(generator: torch.Generator, cfg: ModelConfig, pos: int, n: int) -> dict:
    """``n`` blocks of period position ``pos`` drawn in turn, every leaf
    stacked ``[n, ...]``: each block is copied into its slot as it is
    drawn, so one unstacked block is alive at a time, not all ``n`` (at
    qwen2-vl-7b's full depth, 26 GB)."""
    def alloc(tree):
        return {k: alloc(v) if isinstance(v, dict) else v.new_empty((n, *v.shape))
                for k, v in tree.items()}

    def put(stacked, tree, i):
        for k, v in tree.items():
            if isinstance(v, dict):
                put(stacked[k], v, i)
            else:
                stacked[k][i].copy_(v)

    stacked = None
    for i in range(n):
        block = _init_block(generator, cfg, pos)
        if stacked is None:
            stacked = alloc(block)
        put(stacked, block, i)
    return stacked


def init_params(generator: torch.Generator, cfg: ModelConfig) -> dict[str, Any]:
    """``{'blocks': [period][stacked over groups], 'final_norm'[, 'head']}``
    drawn from ``generator`` on its device.  The draws are torch's, not JAX's:
    a parity test carries the reference's params across instead.  The
    embedding table is not here (see ``training.lm_trainer.init_state``);
    untied archs get a float ``head`` [V, d]."""
    check_supported(cfg)
    blocks = [_stacked_blocks(generator, cfg, pos, cfg.n_groups) for pos in range(cfg.period)]
    params: dict[str, Any] = {
        "blocks": blocks,
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.param_dtype,
                                 device=generator.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init(generator, (cfg.vocab_size, cfg.d_model),
                                      fan_in=cfg.d_model, dtype=cfg.param_dtype)
    return params


def params_from_numpy(cfg: ModelConfig, tree: dict, *, device: str | torch.device = "cuda"
                      ) -> dict[str, Any]:
    """The reference's params (``repro.models.transformer.init_params``'s
    layout, numpy or tensor leaves: ``blocks`` a list per period position,
    each leaf stacked ``[n_groups, ...]``; weights ``[in, out]``) as fp32
    params on ``device``, their structure checked against ``cfg``."""
    dev = device_mod.resolve(device)
    check_supported(cfg)
    if len(tree["blocks"]) != cfg.period:
        raise ValueError(f"{len(tree['blocks'])} block positions != period {cfg.period}")

    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [convert(v) for v in x]
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.float32)
        return torch.as_tensor(np.array(x), dtype=torch.float32).to(dev)

    params = convert(tree)
    for pos, block in enumerate(params["blocks"]):
        want = _block_keys(cfg, pos)
        if set(block) != want:
            raise ValueError(f"{cfg.name}: block position {pos} holds {sorted(block)}, "
                             f"the config needs {sorted(want)}")
        if any(t.shape[0] != cfg.n_groups for t in tree_leaves(block)):
            raise ValueError(f"block leaves must be stacked over {cfg.n_groups} groups")
    if cfg.tie_embeddings == ("head" in params):
        raise ValueError(f"{cfg.name}: tie_embeddings={cfg.tie_embeddings} but the params "
                         f"{'hold' if 'head' in params else 'lack'} a head")
    return params


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def _group(tree: Any, i: int) -> Any:
    """Group ``i`` of a tree stacked ``[n_groups, ...]`` (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _group(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------- blocks


def _decode_slots(cfg: ModelConfig, cache_size: int, cl: torch.Tensor, b: int):
    """``(rows, write_idx [B], valid [B, S])`` of a decode step, the same in
    every layer.  SWA caches are window-sized ring buffers (slot = position %
    size), whose window mask is off.  ``cl`` is one length for every row or
    per-slot lengths (continuous batching): each row writes its token at its
    own cache position, clamped to the last slot as the reference's update is."""
    ring = cfg.sliding_window is not None and cache_size <= cfg.sliding_window
    write_idx = cl % cache_size if ring else torch.clamp_max(cl, cache_size - 1)
    valid_len = torch.clamp_max(cl + 1, cache_size) if ring else cl + 1
    valid = L.decode_mask(valid_len, cache_size, b,
                          window=None if ring else cfg.sliding_window, device=cl.device)
    rows = torch.arange(b, device=cl.device)
    return rows, write_idx.reshape(-1).expand(b).long(), valid


def _attn_block(p, x, cfg: ModelConfig, *, rope, cache=None, slots=None,
                use_kernel: bool = True, train: bool = False, seq: bool = False):
    """Pre-norm attention; ``rope`` is :func:`rope_of` the positions.
    ``cache=None``: full sequence through the flash kernel (``train``: the
    differentiable ``flash_attention_train``), returning the rope'd ``(k,
    v)`` for the prefill cache.  Else a single-token decode against
    ``cache`` (``{"k", "v"}`` [B, S, KH, D], written **in place** where
    ``slots`` (``_decode_slots``) says).

    A model shard of the heads (``wq`` narrower than the padded heads: the
    reference's ``q_heads`` / ``kv_heads`` hints) runs this rank's heads
    between :func:`~repro_torch.dist.tensor_parallel.enter` and ``leave``.
    Where the specs cut the projections mid-head (heads that do not split
    over the model axis), every sharded leaf is gathered whole
    (``tp.whole``) and the attention runs replicated on every rank, with
    neither the input's all-reduce nor the output's: each rank already
    computes the whole gradient.  ``seq``: ``x`` is this rank's block of
    the sequence (``carry``).  Under fsdp the projections' blocks over the
    data axis are gathered first (``tp.fsdp_whole``), so a leaf that
    ``tp.whole`` gathers is gathered over both axes."""
    b, t, _ = x.shape
    h, kv = cfg.padded_heads
    hd = cfg.hd
    shapes = _attn_shapes(cfg)
    a = tp.fsdp_whole(p["attn"], shapes)
    y = L.rms_norm(x, tp.partial_weight(p["norm1"], seq))
    sharded = a["wq"].shape[-1] < h * hd or a["wk"].shape[-1] < kv * hd
    m = tp.model_size()
    if sharded and (h % m or kv % m):
        a, sharded = {k: tp.whole(v, shapes[k]) for k, v in a.items()}, False
    y = tp.enter(y, sharded, seq)
    t, h, kv = y.shape[1], a["wq"].shape[-1] // hd, a["wk"].shape[-1] // hd
    q = y @ a["wq"]
    k = y @ a["wk"]
    v = y @ a["wv"]
    if cfg.attn_bias:
        q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
    q = q.reshape(b, t, h, hd)
    k = k.reshape(b, t, kv, hd)
    v = v.reshape(b, t, kv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, tp.partial_weight(a["q_norm"], sharded))
        k = L.rms_norm(k, tp.partial_weight(a["k_norm"], sharded))
    q = L.apply_rope(q, *rope)
    k = L.apply_rope(k, *rope)

    if cache is None and train:
        o = L.flash_attention_train(q, k, v, causal=cfg.causal, window=cfg.sliding_window,
                                    q_block=cfg.attn_q_block, k_block=cfg.attn_k_block)
        new_kv = (k, v)
    elif cache is None:
        o = L.flash_attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window,
                              use_kernel=use_kernel)
        new_kv = (k, v)
    else:
        rows, write_idx, valid = slots
        cache["k"][rows, write_idx] = k[:, 0]
        cache["v"][rows, write_idx] = v[:, 0]
        o = L.decode_attention(q, cache["k"], cache["v"], None, valid=valid)
        new_kv = None
    o = tp.leave(o.reshape(b, t, h * hd) @ a["wo"], sharded, seq)
    return x + o, new_kv


#: The mixer's leaves the specs replicate that every SSD head reads.
_SSM_SHARED = frozenset({"wB", "wC", "conv_B", "conv_C", "conv_bB", "conv_bC"})


def _mamba_block(p, x, cfg: ModelConfig, *, cache=None, return_cache: bool = False,
                 seq: bool = False):
    """Pre-norm mamba mixer over the full sequence (``return_cache``: with its
    decode cache), or one recurrent step against ``cache`` -> ``(x, cache)``.

    A model shard of the mixer (``wx`` narrower than ``d_inner``: its z / x
    / dt columns, conv channels, SSD heads and gated-norm weights over
    'model', ``out_proj``'s rows) runs this rank's heads between
    ``tp.enter`` and ``tp.leave``; the replicated B / C streams feed every
    rank's heads, so their weights take ``tp.partial_weight``.  SSD heads
    that do not split while ``d_inner`` does are gathered whole and run
    replicated, as a mid-head attention shard is.  ``seq`` and fsdp as in
    :func:`_attn_block`."""
    y = L.rms_norm(x, tp.partial_weight(p["norm1"], seq))
    if cache is None:
        s = cfg.ssm
        shapes = ssm_mod.param_shapes(s)
        mp = tp.fsdp_whole(p["mamba"], shapes)
        sharded = mp["wx"].shape[-1] < s.d_inner
        if sharded and s.n_heads % tp.model_size():
            mp, sharded = {k: tp.whole(v, shapes[k]) for k, v in mp.items()}, False
        elif sharded:
            mp = {k: tp.partial_weight(v, k in _SSM_SHARED) for k, v in mp.items()}
        out, c = ssm_mod.ssm_forward(mp, tp.enter(y, sharded, seq), s,
                                     return_cache=return_cache)
        return x + tp.leave(out, sharded, seq), c
    out, new_cache = ssm_mod.ssm_decode_step(p["mamba"], y, cfg.ssm, cache)
    return x + out, new_cache


def _mlp_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The whole shapes of one layer's dense MLP leaves (:func:`_init_block`)."""
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d), "w_in": (d, f), "b_in": (f,),
            "w_out": (f, d), "b_out": (d,)}


def _mlp_block(p, x, cfg: ModelConfig, pos: int, seq: bool = False):
    """The MLP or MoE sub-layer -> ``(x, aux)``, ``aux`` the MoE's
    load-balance loss or None where there is no MoE.  A model shard of the
    MLP's hidden dim runs between ``tp.enter`` and ``tp.leave`` (the MoE's
    expert shards inside ``moe_forward``, or ``moe_forward_ep`` under an
    ``ep`` policy, which reads the whole sequence, as the reference's
    ``shard_map`` takes it, so under sp the rank's block is gathered before
    it and cut after); a bias on the output is added once, after the
    reduce; ``seq`` and fsdp (the dense MLP's projections; never the
    experts) as in :func:`_attn_block`."""
    if not cfg.is_moe(pos) and cfg.d_ff == 0:
        return x, None
    y = L.rms_norm(x, tp.partial_weight(p["norm2"], seq))
    if cfg.is_moe(pos):
        if dist_ctx.moe_ep_context() is not None and cfg.moe.n_experts % tp.model_size() == 0:
            # The reference's _moe_apply: the explicit EP dispatch under an
            # ep policy; the path below where E does not split.
            forward = moe_mod.moe_forward_ep
        else:
            forward = moe_mod.moe_forward
        out, aux = forward(p["moe"], tp.enter(y, False, seq), cfg.moe)
        return x + tp.leave(out, False, seq), aux
    m = tp.fsdp_whole(p["mlp"], _mlp_shapes(cfg))
    if cfg.mlp_type == "gelu":
        # b_out is added to this rank's block of T under sequence
        # parallelism: a replicated weight that reads part of its input.
        sharded = m["w_in"].shape[-1] < cfg.d_ff
        out = L.gelu_mlp(tp.enter(y, sharded, seq), m["w_in"], m["b_in"], m["w_out"],
                         tp.partial_weight(m["b_out"], seq),
                         reduce=lambda o: tp.leave(o, sharded, seq))
        return x + out, None
    sharded = m["w_gate"].shape[-1] < cfg.d_ff
    out = L.swiglu(tp.enter(y, sharded, seq), m["w_gate"], m["w_up"], m["w_down"])
    return x + tp.leave(out, sharded, seq), None


def _period_fwd(blocks: list, x: torch.Tensor, rope, cfg: ModelConfig, use_kernel: bool,
                train: bool, seq: bool = False):
    """One group: the ``cfg.period`` layers of ``blocks`` (a group's blocks,
    one per period position) over ``x`` -> ``(x, aux)``, ``aux`` the group's
    summed MoE loss or None where there is no MoE; ``seq``: ``x`` is this
    rank's block of the sequence."""
    group_aux = None
    for pos, p in enumerate(blocks):
        if cfg.layer_type(pos) == "attn":
            x, _ = _attn_block(p, x, cfg, rope=rope, use_kernel=use_kernel, train=train,
                               seq=seq)
        else:
            x, _ = _mamba_block(p, x, cfg, seq=seq)
        x, a = _mlp_block(p, x, cfg, pos, seq)
        if a is not None:
            group_aux = a if group_aux is None else group_aux + a
    return x, group_aux


# --------------------------------------------------------------------- fwd


def backbone(params: dict[str, Any], embeds: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor, *, use_kernel: bool = True,
             train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hidden [B, T, d] after the final norm, MoE aux loss)``, the aux summed
    per group and then over the groups as the reference's scan does;
    ``train`` runs the differentiable training attention instead of the
    forward-only kernel.  With ``cfg.remat`` each group's forward, its aux
    included, runs under ``torch.utils.checkpoint`` (non-reentrant): the
    backward recomputes what it needs from the group's inputs, so under
    grad mode a group keeps its inputs instead of its activations, and the
    gradients are bitwise those without remat (the same graph, its saved
    tensors recomputed by the same operations).

    Under a sequence-parallel context (``tp.seq_split``, the reference's
    ``activation`` / ``carry`` hints) the residual stream between the
    sub-layers is this rank's block of T; the hidden comes back whole.
    Under fsdp (``tp.fsdp_active``) every group runs as with remat, so the
    projections it gathers over the data axis are freed after its forward
    and gathered again for its backward: the whole model is never
    gathered at once."""
    check_supported(cfg)
    x = embeds.to(cfg.dtype)
    seq = tp.seq_split(tuple(x.shape))
    if seq:
        x = tp.slice_along(x, 1)
    rope = rope_of(positions, cfg) if _has_attention(cfg) else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi in range(cfg.n_groups):
        blocks = [_group(params["blocks"][pos], gi) for pos in range(cfg.period)]
        if cfg.remat or tp.fsdp_active():
            x, group_aux = torch.utils.checkpoint.checkpoint(
                _period_fwd, blocks, x, rope, cfg, use_kernel, train, seq, use_reentrant=False)
        else:
            x, group_aux = _period_fwd(blocks, x, rope, cfg, use_kernel, train, seq)
        if group_aux is not None:
            aux = aux + group_aux
    h = L.rms_norm(x, tp.partial_weight(params["final_norm"], seq))
    return (tp.gather_along(h, 1) if seq else h), aux


def embed_tokens(table, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token rows from a serving table (``QuantTable`` through the
    ``dequant_gather`` kernel) or a raw float [V, d] tensor."""
    return serving_tbl.rows(table, tokens).to(cfg.dtype)


def head_logits(params, table, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits [.., V]: a tied int8-resident table contracts through
    ``ops.dequant_matmul`` (the fp32 table never exists); a float table or an
    untied head is a plain fp32 matmul."""
    w = table if cfg.tie_embeddings else params["head"]
    return serving_tbl.head_logits(w, h)


def chunked_ce_loss(params, table_fp: torch.Tensor, h: torch.Tensor, labels: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Mean cross-entropy of ``h`` [B, T, d] against ``labels`` [B, T] (-1:
    ignored) without the [B, T, V] logits: chunks of ``cfg.ce_chunk``
    positions (one chunk when it does not divide T) summed in order, each
    chunk's logits recomputed in the backward (``jax.checkpoint`` of the
    reference's scan body)."""
    b, t, d = h.shape
    chunk = min(cfg.ce_chunk, t)
    if t % chunk:
        chunk = t
    w = table_fp if cfg.tie_embeddings else params["head"]

    def piece(h_blk, l_blk, w):
        labels = torch.clamp_min(l_blk, 0).long()
        # A model shard of the head (the reference's head_weight / logits
        # hints): the vocab-parallel cross-entropy.
        per = tp.token_losses(w, h_blk, labels, cfg.vocab_size, serving_tbl.head_logits)
        if per is None:
            logits = serving_tbl.head_logits(w, h_blk)
            per = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1,
                                                                 labels[..., None])[..., 0]
        mask = (l_blk >= 0).to(torch.float32)
        return torch.sum(per * mask), torch.sum(mask)

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, t, chunk):
        s, c = torch.utils.checkpoint.checkpoint(piece, h[:, c0:c0 + chunk],
                                                 labels[:, c0:c0 + chunk], w,
                                                 use_reentrant=False)
        tot, cnt = tot + s, cnt + c
    return tot / torch.clamp_min(cnt, 1.0)


def assemble_embeds(table_fp: torch.Tensor, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Input embeddings [B, T, d] of every input mode: ``embeds`` returns
    ``batch["embeds"]`` (the encoder's frames; the table is not read);
    otherwise the rows of ``batch["tokens"]``, and in the ``mixed`` mode
    ``batch["prefix_embeds"]`` [B, P, d] (P = ``cfg.visual_prefix``)
    replaces token positions 0..P-1."""
    check_supported(cfg)
    if cfg.input_mode == "embeds":
        return batch["embeds"].to(cfg.dtype)
    if tp.active() is not None:  # a model shard of the table (embed_table)
        tok_emb = tp.embed_rows(table_fp, batch["tokens"], cfg.vocab_size,
                                cfg.d_model).to(cfg.dtype)
    else:
        tok_emb = embed_tokens(table_fp, batch["tokens"], cfg)
    if cfg.input_mode == "mixed" and cfg.visual_prefix > 0:
        prefix = batch["prefix_embeds"].to(cfg.dtype)
        return torch.cat([prefix, tok_emb[:, cfg.visual_prefix:]], dim=1)
    return tok_emb


def loss_fn(params: dict[str, Any], table_fp: torch.Tensor, batch: dict,
            cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Training loss ``(ce + aux, aux)`` from the dense fp32 table [V, d]
    (``aux`` is the MoE load-balance loss, 0 without MoE layers).  Under dp
    the table (where the model reads it) and the untied head enter whole
    (``tp.vocab_whole``)."""
    v, d = cfg.vocab_size, cfg.d_model
    if cfg.input_mode != "embeds" or cfg.tie_embeddings:
        table_fp = tp.vocab_whole(table_fp, v, d)
    if "head" in params:
        params = dict(params, head=tp.vocab_whole(params["head"], v, d))
    embeds = assemble_embeds(table_fp, batch, cfg)
    b, t, _ = embeds.shape
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(b, t, cfg, device=embeds.device)
    h, aux = backbone(params, embeds, cfg, positions, train=True)
    return chunked_ce_loss(params, table_fp, h, batch["labels"], cfg) + aux, aux


def default_positions(b: int, t: int, cfg: ModelConfig, device=None) -> torch.Tensor:
    """Positions 0..t-1 for each of ``b`` rows, int32 [b, t]; for M-RoPE
    [3, b, t], the three streams equal (text)."""
    pos = torch.arange(t, dtype=torch.int32, device=device)[None, :].expand(b, t)
    if cfg.mrope_sections is not None:
        return pos[None].expand(3, b, t)
    return pos


# --------------------------------------------------------------------- decode


def cache_len_for(cfg: ModelConfig, max_len: int) -> int:
    """KV slots per attention layer: SWA archs get a window-sized ring buffer."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def check_prompt_len(cfg: ModelConfig, t: int) -> None:
    """Raise ``ValueError`` for a prompt an exact-length prefill cannot take:
    a mamba layer's chunked SSD needs a prompt of at most one chunk or a
    multiple of it, and at least its conv window (``ssm.check_prefill_len``)."""
    if _has_mamba(cfg):
        ssm_mod.check_prefill_len(cfg.ssm, t)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: str | torch.device = "cuda") -> list:
    """Decode cache, one entry per period position stacked over groups, the
    reference's layout: ``{"k", "v"}`` ``[n_groups, batch, kv_len, KH, D]``
    zeros for an attention layer, the SSM cache ``[n_groups, batch, ...]``
    zeros for a mamba layer."""
    check_supported(cfg)
    _, kv = cfg.padded_heads
    g = cfg.n_groups
    caches = []
    for pos in range(cfg.period):
        if cfg.layer_type(pos) == "attn":
            shape = (g, batch, cache_len_for(cfg, max_len), kv, cfg.hd)
            caches.append({"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                           "v": torch.zeros(shape, dtype=cfg.dtype, device=device)})
        else:
            one = ssm_mod.init_ssm_cache(cfg.ssm, batch, cfg.dtype, device=device)
            caches.append({k: v.new_zeros((g, *v.shape)) for k, v in one.items()})
    return caches


def decode_step(params, table, token: torch.Tensor, cache: list, cache_len,
                cfg: ModelConfig, *, use_kernel: bool = True):
    """One serve step: ``(logits [B, V], cache)``; the cache is updated **in
    place** (the reference donates it) and returned.

    ``cache_len`` is an int or a per-slot int [B] tensor: the tokens already
    in each slot's cache, and the RoPE position of its new token.  A mamba
    layer steps its recurrent state whatever the length.
    """
    check_supported(cfg)
    b = token.shape[0]
    x = embed_tokens(table, token[:, None], cfg)
    rope = slots = None
    if _has_attention(cfg):
        cl = torch.as_tensor(cache_len, dtype=torch.int32, device=token.device)
        offset = cl[:, None] if cl.ndim == 1 else cl
        positions = default_positions(b, 1, cfg, device=token.device) + offset
        rope = rope_of(positions, cfg)
        first = cfg.layer_types.index("attn")
        slots = _decode_slots(cfg, cache[first]["k"].shape[2], cl, b)
    for gi in range(cfg.n_groups):
        for pos in range(cfg.period):
            p = _group(params["blocks"][pos], gi)
            layer_cache = _group(cache[pos], gi)
            if cfg.layer_type(pos) == "attn":
                x, _ = _attn_block(p, x, cfg, rope=rope, cache=layer_cache, slots=slots,
                                   use_kernel=use_kernel)
            else:
                x, new = _mamba_block(p, x, cfg, cache=layer_cache)
                for key, t in new.items():
                    layer_cache[key].copy_(t)
            x, _ = _mlp_block(p, x, cfg, pos)
    h = L.rms_norm(x, params["final_norm"])
    return head_logits(params, table, h[:, 0], cfg), cache


def prefill(params, table, tokens: torch.Tensor, cfg: ModelConfig, max_len: int,
            lens: torch.Tensor | None = None, *, use_kernel: bool = True):
    """Run the full prompt and build its decode cache -> ``(logits_last, cache)``.

    ``lens`` ([B], optional) marks each row's true length in a right-padded
    batch: the logits come from position ``lens - 1``.  Causal attention
    masks the padding exactly, but the padded length changes the reduction
    shapes, so that path matches an exact-length prefill to an ulp, not
    bitwise; the serving engine prefills each request at its exact length.
    A mamba layer's state would run through the padding, so a stack with
    one refuses ``lens``, and its prompt must pass :func:`check_prompt_len`.
    """
    check_supported(cfg)
    b, t = tokens.shape
    if lens is not None and _has_mamba(cfg):
        raise ValueError(f"{cfg.name}: a right-padded prefill (lens) would run the SSM state "
                         "through the padding; prefill each prompt at its exact length")
    x = embed_tokens(table, tokens, cfg)
    kv_len = cache_len_for(cfg, max_len)
    # Ring layout: position p lives in slot p % kv_len; only the last kv_len
    # positions survive.
    n_keep = min(t, kv_len)
    slots = torch.arange(t - n_keep, t, device=tokens.device) % kv_len
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    rope = None
    if _has_attention(cfg):
        positions = default_positions(b, t, cfg, device=tokens.device)
        rope = rope_of(positions, cfg)
    for gi in range(cfg.n_groups):
        for pos in range(cfg.period):
            p = _group(params["blocks"][pos], gi)
            if cfg.layer_type(pos) == "attn":
                x, (k, v) = _attn_block(p, x, cfg, rope=rope, use_kernel=use_kernel)
                cache[pos]["k"][gi][:, slots] = k[:, t - n_keep:]
                cache[pos]["v"][gi][:, slots] = v[:, t - n_keep:]
            else:
                x, c = _mamba_block(p, x, cfg, return_cache=True)
                for key, val in c.items():
                    cache[pos][key][gi].copy_(val)
            x, _ = _mlp_block(p, x, cfg, pos)
    h_final = L.rms_norm(x, params["final_norm"])
    if lens is None:
        h_last = h_final[:, -1]
    else:
        idx = torch.clamp(torch.as_tensor(lens, device=tokens.device).long() - 1, 0, t - 1)
        h_last = h_final[torch.arange(b, device=tokens.device), idx]
    return head_logits(params, table, h_last, cfg), cache
