"""The port's LM layers and transformer against the JAX package.

The reference's ``lm_trainer.init_state`` builds params and the ALPT vocab
table for each smoke config; ``interop`` carries them into the port, and the
same prompts go through both ``prefill`` / ``decode_step`` (the reference
jitted, as its engine runs them; the port on the CPU, where the flash
attention, gather and head kernels take their plain versions).

Tolerance: logits and KV caches within atol 5e-5, rtol 1e-5.  The measured
gap is ~5e-6 on logits of magnitude ~4: fp32 matmuls summed in another order
and XLA's own sin/cos/rsqrt polynomials, through 2-3 layers.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import methods as jmethods
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.training import lm_trainer as jlm
from repro_torch import configs, interop
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.optim import tree_leaves
from repro_torch.training import lm_trainer

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["smollm-135m", "qwen3-1.7b", "h2o-danube-1.8b"]
TOL = dict(atol=5e-5, rtol=1e-5)


def _pair(arch, bits=8, seed=1):
    """(port cfg, port params, port table, ref cfg, ref params, ref table)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), embedding_bits=bits)
    cfg = dataclasses.replace(configs.smoke_config(arch), embedding_bits=bits)
    tcfg = jlm.LMTrainerConfig()
    state = jlm.init_state(jax.random.PRNGKey(seed), jcfg, tcfg)
    jspec = jlm.embedding_spec_of(jcfg, tcfg)
    jtable = jmethods.get(jspec.method).serving_state(state.table, jspec)
    params = interop.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, state.params),
                                          device="cpu")
    table = interop.quant_table_from_numpy(
        lm_trainer.embedding_spec_of(cfg), codes=np.asarray(jtable.codes.data),
        step=np.asarray(jtable.step), device="cpu")
    return cfg, params, table, jcfg, state.params, jtable


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_configs_match_the_reference():
    for arch in ARCHS:
        for make in ("full_config", "smoke_config"):
            got, want = getattr(configs, make)(arch), getattr(jconfigs, make)(arch)
            fields = {f.name for f in dataclasses.fields(got)} - {"dtype", "param_dtype"}
            assert fields == {f.name for f in dataclasses.fields(want)} - {"dtype", "param_dtype"}
            assert all(getattr(got, f) == getattr(want, f) for f in fields), (arch, make)
            assert got.padded_heads == want.padded_heads and got.hd == want.hd
    assert configs.full_config("smollm-135m", embedding_bits=4).embedding_bits == 4
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    cfg = configs.smoke_config(arch)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    want = jtfm.init_params(jax.random.PRNGKey(0), jconfigs.smoke_config(arch))
    got_shapes = jax.tree.map(lambda t: tuple(t.shape), params)
    want_shapes = jax.tree.map(lambda a: tuple(a.shape), want)
    assert got_shapes == want_shapes
    assert tfm.param_count(params) == jtfm.param_count(want)
    # The same scale as the reference's draws: N(0, 1/fan_in).
    wq = params["blocks"][0]["attn"]["wq"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1


def test_layers_match_the_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 3, 64).astype(np.float32)
    w = (rng.rand(64) + 0.5).astype(np.float32)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jax.jit(jlayers.rms_norm)(x, w))
    for base, hd in ((10000.0, 64), (1_000_000.0, 128), (10000.0, 80)):
        pos = np.arange(300, dtype=np.int32)[None].repeat(2, 0)
        cos, sin = L.rope_angles(torch.from_numpy(pos), hd, base)
        jcos, jsin = jax.jit(jlayers.rope_angles, static_argnums=(1, 2))(pos, hd, base)
        _close(cos, jcos)
        _close(sin, jsin)
        # The frequencies themselves are XLA's powf, bit for bit.
        half = hd // 2
        want = np.asarray(jax.jit(lambda: base ** (-jnp.arange(0, half, dtype=jnp.float32)
                                                   / half))())
        np.testing.assert_array_equal(L._rope_freqs(hd, base), want)
    xr = rng.randn(2, 5, 3, 16).astype(np.float32)
    cos, sin = (rng.randn(2, 5, 8).astype(np.float32) for _ in range(2))
    _close(L.apply_rope(*map(torch.from_numpy, (xr, cos, sin))),
           jax.jit(jlayers.apply_rope)(xr, cos, sin))
    h = rng.randn(3, 4, 32).astype(np.float32)
    wg, wu = (rng.randn(32, 48).astype(np.float32) * 0.2 for _ in range(2))
    wd = rng.randn(48, 32).astype(np.float32) * 0.2
    _close(L.swiglu(*map(torch.from_numpy, (h, wg, wu, wd))),
           jax.jit(jlayers.swiglu)(h, wg, wu, wd))


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("scalar_len", [True, False])
def test_decode_attention_matches_the_reference(window, scalar_len):
    rng = np.random.RandomState(1)
    q = rng.randn(3, 1, 6, 16).astype(np.float32)
    k, v = (rng.randn(3, 20, 2, 16).astype(np.float32) for _ in range(2))
    cl = np.int32(11) if scalar_len else np.array([3, 20, 9], np.int32)
    got = L.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             torch.as_tensor(cl), window=window)
    want = jax.jit(functools.partial(jlayers.decode_attention, window=window))(q, k, v, cl)
    _close(got, want)


@pytest.mark.parametrize("arch,bits", [(a, 8) for a in ARCHS] + [("smollm-135m", 4)])
def test_prefill_and_decode_match_the_reference(arch, bits):
    """Logits and caches of a batch-2 prefill, then 4 decode steps with a
    per-slot ``cache_len`` vector.  Danube's prompt (40) outlasts its window
    (32): prefill keeps the ring, decode writes it at ``len % 32``."""
    cfg, params, table, jcfg, jparams, jtable = _pair(arch, bits)
    t, max_len = 40, 48
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, t)).astype(np.int32)
    jl, jc = jax.jit(functools.partial(jtfm.prefill, cfg=jcfg, max_len=max_len))(
        jparams, jtable, jnp.asarray(toks))
    logits, cache = tfm.prefill(params, table, torch.from_numpy(toks), cfg, max_len)
    _close(logits, jl)
    assert len(cache) == len(jc) == cfg.period
    for c, jcc in zip(cache, jc):
        assert tuple(c["k"].shape) == jcc["k"].shape
        _close(c["k"], jcc["k"])
        _close(c["v"], jcc["v"])

    jdecode = jax.jit(functools.partial(jtfm.decode_step, cfg=jcfg))
    tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    cl = np.array([t, t - 3], np.int32)  # slot 1 as if three tokens shorter
    for _ in range(4):
        jl, jc = jdecode(jparams, jtable, jnp.asarray(tok), jc, jnp.asarray(cl))
        logits, cache = tfm.decode_step(params, table, torch.tensor(tok), cache,
                                        torch.tensor(cl), cfg)
        _close(logits, jl)
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        cl = cl + 1
    for c, jcc in zip(cache, jc):
        _close(c["k"], jcc["k"])
        _close(c["v"], jcc["v"])


def test_backbone_matches_the_reference():
    cfg, params, table, jcfg, jparams, jtable = _pair("qwen3-1.7b")
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    emb = tfm.embed_tokens(table, torch.from_numpy(toks), cfg)
    _close(emb, jtfm.embed_tokens(jtable, jnp.asarray(toks), jcfg))
    pos = tfm.default_positions(2, 9, cfg)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jtfm.default_positions(2, 9, jcfg)))
    h, _ = jax.jit(functools.partial(jtfm.backbone, cfg=jcfg))(
        jparams, jtfm.embed_tokens(jtable, jnp.asarray(toks), jcfg), positions=jnp.asarray(pos))
    got, aux = tfm.backbone(params, emb, cfg, pos)
    _close(got, h)
    assert float(aux) == 0.0


def test_scalar_cache_len_and_lens_match_the_reference():
    """The lock-step decode (one ``cache_len`` for all rows) and a
    right-padded prefill with ``lens``."""
    cfg, params, table, jcfg, jparams, jtable = _pair("qwen3-1.7b")
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    jl, jc = jtfm.prefill(jparams, jtable, jnp.asarray(toks), jcfg, 16, lens=jnp.asarray(lens))
    logits, cache = tfm.prefill(params, table, torch.from_numpy(toks), cfg, 16,
                                lens=torch.from_numpy(lens))
    _close(logits, jl)
    tok = np.array([5, 9], np.int32)
    jl, _ = jax.jit(functools.partial(jtfm.decode_step, cfg=jcfg))(
        jparams, jtable, jnp.asarray(tok), jc, jnp.asarray(12, jnp.int32))
    logits, _ = tfm.decode_step(params, table, torch.from_numpy(tok), cache, 12, cfg)
    _close(logits, jl)


def test_untied_head_and_float_table_match_the_reference():
    """Danube's untied float head, and a tied head over a float table (the
    ``FloatTable`` / raw-tensor paths of ``serving.table``)."""
    cfg, params, table, jcfg, jparams, jtable = _pair("h2o-danube-1.8b")
    h = np.random.RandomState(4).randn(3, cfg.d_model).astype(np.float32)
    _close(tfm.head_logits(params, table, torch.from_numpy(h), cfg),
           jtfm.head_logits(jparams, jtable, jnp.asarray(h), jcfg))
    from repro_torch.serving import table as serving_tbl

    dense = table.rows(torch.arange(cfg.vocab_size))
    np.testing.assert_array_equal(serving_tbl.FloatTable(dense).head_logits(torch.from_numpy(h)),
                                  serving_tbl.head_logits(dense, torch.from_numpy(h)))


def test_unported_architectures_raise():
    """Every feature of the reference's configs is taken, with the
    reference's param layout: the mixed input mode and M-RoPE (the VLM
    slice), the gelu MLP and remat (the encoder and remat slice); only a
    malformed config is refused, by name."""
    cfg, jcfg = configs.smoke_config("smollm-135m"), jconfigs.smoke_config("smollm-135m")
    for bad, what in ((dict(mlp_type="relu"), "mlp_type"),
                      (dict(input_mode="frames"), "input_mode")):
        with pytest.raises(ValueError, match=what):
            tfm.init_params(torch.Generator().manual_seed(0), dataclasses.replace(cfg, **bad))
    for ported in (dict(input_mode="mixed", visual_prefix=4),
                   dict(mrope_sections=(8, 12, 12)), dict(mlp_type="gelu"), dict(remat=True)):
        params = tfm.init_params(torch.Generator().manual_seed(0),
                                 dataclasses.replace(cfg, **ported))
        want = jax.eval_shape(lambda k: jtfm.init_params(k, dataclasses.replace(jcfg, **ported)),
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
        assert [tuple(t.shape) for t in tree_leaves(params)] == [
            a.shape for a in jax.tree.leaves(want)], ported


def test_init_state_builds_params_and_an_alpt_table():
    cfg = configs.smoke_config("smollm-135m")
    state = lm_trainer.init_state(cfg, seed=3, device="cpu")
    spec = lm_trainer.embedding_spec_of(cfg)
    assert spec.init_scale == cfg.d_model ** -0.5 and spec.method == "alpt"
    assert state.table.codes.data.shape == (cfg.vocab_size, cfg.d_model)
    assert state.table.codes.data.dtype == torch.int8 and state.step == 0
    again = lm_trainer.init_state(cfg, seed=3, device="cpu")
    assert torch.equal(state.table.codes.data, again.table.codes.data)
    assert torch.equal(state.params["blocks"][0]["attn"]["wq"],
                       again.params["blocks"][0]["attn"]["wq"])
    packed = lm_trainer.init_state(dataclasses.replace(cfg, embedding_bits=4), device="cpu")
    assert packed.table.codes.packed and packed.table.codes.data.shape == (cfg.vocab_size, 24)
