"""The port's SSM (Mamba2 / SSD) and MoE layers against the JAX package.

The same inputs, made from a seed with numpy, go through the reference's
functions jitted and the port's on the CPU.  Parameters are the reference's
own draws (``init_ssm`` / ``init_moe``), carried across as numpy.

Tolerances, each with the gap measured when it was set:
- ``_causal_conv``: atol 1e-6 (measured 2.4e-7): four fp32 products summed
  in the same order, XLA's and torch's own sigmoid;
- ``ssd_chunked``: outputs and the carried state within atol 2e-5 on
  outputs up to ~12 (measured 1.9e-6 and 2.4e-7): per-chunk einsums
  contracted in another order;
- ``ssm_forward`` / ``ssm_decode_step``: outputs and caches within atol 2e-5
  (measured 9.5e-7);
- gradients of the mixer: within 1e-4 of each leaf's largest entry
  (measured 1.5e-6 at the smoke width, 1.2e-5 where the reference's are
  finite at 32 heads);
- ``moe_forward``: outputs within atol 1e-5 (measured 1.9e-6), the aux loss
  within rtol 1e-6 (measured equal), every gradient within 1e-5 of its
  leaf's largest entry (measured 3.2e-7); the routing (top-k, capacity,
  drops) is integer work and agrees exactly, checked on its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.models import moe, ssm

jax.config.update("jax_platform_name", "cpu")
f32 = np.float32


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


def _rel_close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=rel * np.abs(want).max(), rtol=0)


# ------------------------------------------------------------------ SSM pieces


SMOKE_SSM = dict(d_model=64, d_state=32, headdim=16, expand=2, chunk=32)


def test_causal_conv_matches_the_reference():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 11, 6).astype(f32)
    w = (rs.randn(4, 6) * 0.3).astype(f32)
    b = rs.randn(6).astype(f32)
    want = jax.jit(jssm._causal_conv)(x, w, b)
    _close(ssm._causal_conv(*map(torch.from_numpy, (x, w, b))), want, atol=1e-6)


@pytest.mark.parametrize("t,chunk,with_state", [(64, 16, True), (48, 48, False), (96, 32, True)])
def test_ssd_chunked_carries_the_state_as_the_reference(t, chunk, with_state):
    """Several chunks, so the inter-chunk state is carried, from a zero or a
    given initial state: the outputs and the final state."""
    rs = np.random.RandomState(t)
    b, h, p, n = 2, 4, 8, 16
    x = rs.randn(b, t, h, p).astype(f32)
    dt = (rs.rand(b, t, h) * 0.1 + 0.001).astype(f32)
    a = -np.arange(1, h + 1, dtype=f32)
    bb, cc = (rs.randn(b, t, n).astype(f32) for _ in range(2))
    s0 = rs.randn(b, h, p, n).astype(f32) if with_state else None
    y, state = jax.jit(jssm.ssd_chunked, static_argnums=(5,))(x, dt, a, bb, cc, chunk, s0)
    got_y, got_state = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bb, cc)), chunk,
                                       None if s0 is None else torch.from_numpy(s0))
    _close(got_y, y, atol=2e-5)
    _close(got_state, state, atol=2e-5)
    with pytest.raises(ValueError, match="must divide chunk"):
        ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bb, cc)), t - 1)


def test_ssm_forward_cache_and_decode_match_the_reference():
    """The mixer over a prompt of two chunks with its decode cache, then
    three recurrent steps from that cache: outputs and every cache leaf."""
    jcfg, cfg = jssm.SSMConfig(**SMOKE_SSM), ssm.SSMConfig(**SMOKE_SSM)
    jp = jssm.init_ssm(jax.random.PRNGKey(3), jcfg)
    p = _t(jp)
    rs = np.random.RandomState(1)
    u = rs.randn(2, 64, 64).astype(f32)
    jout, jcache = jax.jit(lambda p, u: jssm.ssm_forward(p, u, jcfg, return_cache=True))(jp, u)
    out, cache = ssm.ssm_forward(p, torch.from_numpy(u), cfg, return_cache=True)
    _close(out, jout, atol=2e-5)
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        _close(cache[k], jcache[k], atol=2e-5)
    jstep = jax.jit(lambda p, u, c: jssm.ssm_decode_step(p, u, jcfg, c))
    for i in range(3):
        ui = rs.randn(2, 1, 64).astype(f32)
        jout, jcache = jstep(jp, ui, jcache)
        out, cache = ssm.ssm_decode_step(p, torch.from_numpy(ui), cfg, cache)
        _close(out, jout, atol=2e-5)
        for k in cache:
            _close(cache[k], jcache[k], atol=2e-5)
    # A fresh cache has the reference's shapes and dtypes.
    fresh, jfresh = ssm.init_ssm_cache(cfg, 3, device="cpu"), jssm.init_ssm_cache(jcfg, 3)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in fresh.items()} == {
        k: (tuple(v.shape), f"torch.{v.dtype}") for k, v in jfresh.items()}


def test_ssm_prefill_length_rules():
    """Exact-length prefill only: longer than a chunk means a multiple of it
    (the reference's ValueError), and a cache needs the conv window."""
    cfg = ssm.SSMConfig(**SMOKE_SSM)
    p = ssm.init_ssm(torch.Generator().manual_seed(0), cfg)
    for t in (1, 2, 3, 31, 32, 64):
        u = torch.zeros(1, t, 64)
        if t < 3:
            with pytest.raises(ValueError, match="conv window"):
                ssm.ssm_forward(p, u, cfg, return_cache=True)
            ssm.ssm_forward(p, u, cfg)  # no cache: any length a chunk divides
        else:
            assert ssm.ssm_forward(p, u, cfg, return_cache=True)[1]["conv_x"].shape[1] == 3
    with pytest.raises(ValueError, match="seq 40 must divide chunk 32"):
        ssm.ssm_forward(p, torch.zeros(1, 40, 64), cfg)


def test_init_ssm_has_the_reference_layout():
    jcfg, cfg = jssm.SSMConfig(**SMOKE_SSM), ssm.SSMConfig(**SMOKE_SSM)
    want = jssm.init_ssm(jax.random.PRNGKey(0), jcfg)
    got = ssm.init_ssm(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k in ("conv_B", "conv_C", "conv_bx", "D", "norm_w"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # log(1..h): torch's and XLA's logf differ by an ulp on some entries.
    np.testing.assert_allclose(got["A_log"].numpy(), np.asarray(want["A_log"]), rtol=1e-6)
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert float(dt.min()) >= cfg.dt_min * 0.999 and float(dt.max()) <= cfg.dt_max * 1.001


def _ssm_grads(jcfg, cfg, key, u):
    """(reference, port) gradients of mean(ssm_forward(params, u)^2) w.r.t.
    (params, u), from the reference's init."""
    jp = jssm.init_ssm(jax.random.PRNGKey(key), jcfg)

    def jloss(p, u):
        return jnp.mean(jssm.ssm_forward(p, u, jcfg)[0] ** 2)

    jval, (jgp, jgu) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jp, u)
    p = {k: v.requires_grad_(True) for k, v in _t(jp).items()}
    tu = torch.from_numpy(u).requires_grad_(True)
    val = torch.mean(ssm.ssm_forward(p, tu, cfg)[0] ** 2)
    val.backward()
    return ((float(jval), _np(jgp), np.asarray(jgu)),
            (float(val.detach()), {k: v.grad for k, v in p.items()}, tu.grad))


def test_ssd_masks_before_the_exponential():
    """The deliberate deviation (ROADMAP Queue C).  At 32 heads and chunks
    of 128 (headdim 8: mamba2-370m's head count and chunk at a small width)
    the masked half of the reference's intra-chunk decay overflows: its
    gradients of A_log, dt_bias, wdt and the input are non-finite.  The
    port's forward equals the reference's, its gradients are all finite and
    equal the reference's wherever those are finite."""
    kw = dict(d_model=128, d_state=16, headdim=8, expand=2, chunk=128)
    jcfg, cfg = jssm.SSMConfig(**kw), ssm.SSMConfig(**kw)
    assert cfg.n_heads == 32
    u = np.random.RandomState(0).randn(1, 128, 128).astype(f32)
    (jval, jgp, jgu), (val, gp, gu) = _ssm_grads(jcfg, cfg, 0, u)
    np.testing.assert_allclose(val, jval, rtol=1e-5)
    for name in ("A_log", "dt_bias", "wdt"):
        assert not np.isfinite(jgp[name]).all(), name
    assert not np.isfinite(jgu).any()
    for name, g in gp.items():
        assert torch.isfinite(g).all(), name
        want = jgp[name]
        ok = np.isfinite(want)
        if ok.any():
            np.testing.assert_allclose(g.numpy()[ok], want[ok],
                                       atol=1e-4 * np.abs(want[ok]).max(), rtol=0, err_msg=name)
    assert torch.isfinite(gu).all()


def test_ssd_gradients_match_at_the_smoke_width():
    """At the smoke width no decay overflows: every gradient of both is
    finite, and they agree."""
    jcfg, cfg = jssm.SSMConfig(**SMOKE_SSM), ssm.SSMConfig(**SMOKE_SSM)
    u = np.random.RandomState(2).randn(2, 64, 64).astype(f32)
    (jval, jgp, jgu), (val, gp, gu) = _ssm_grads(jcfg, cfg, 1, u)
    np.testing.assert_allclose(val, jval, rtol=1e-5)
    for name, g in gp.items():
        assert np.isfinite(jgp[name]).all(), name
        _rel_close(g, jgp[name], 1e-4)
    _rel_close(gu, jgu, 1e-4)


# ------------------------------------------------------------------ MoE


MOE_CASES = {
    # DeepSeek-MoE's form: shared experts, raw top-k probabilities.
    "shared_raw_gates": dict(n_experts=8, top_k=3, d_model=32, d_ff=16, n_shared_experts=2,
                             shared_d_ff=48, normalize_gates=False),
    # Mixtral's form: renormalised gates, no shared expert.
    "mixtral": dict(n_experts=4, top_k=2, d_model=32, d_ff=24),
    # A capacity small enough that pairs drop (token order decides which).
    "drops": dict(n_experts=4, top_k=2, d_model=32, d_ff=24, capacity_factor=0.5,
                  n_shared_experts=1),
}


def _routing(cfg, x, router):
    """(expert ids, kept mask) of the reference's dispatch, in numpy."""
    probs = jax.nn.softmax(jnp.asarray(x) @ router, axis=-1)
    _, ids = jax.lax.top_k(probs, cfg.top_k)
    b, s, k = ids.shape
    oh = np.asarray(jax.nn.one_hot(ids, cfg.n_experts, dtype=jnp.int32)).reshape(b, s * k, -1)
    pos = ((np.cumsum(oh, 1) - oh) * oh).sum(-1)
    return np.asarray(ids), pos < jmoe.capacity(cfg, s)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_forward_matches_the_reference(case):
    """Outputs, the aux loss and every gradient (router, experts, shared
    experts, the input) of ``sum(y * ct) + aux``; the routing itself, and
    whether pairs were dropped, as the case says."""
    jcfg, cfg = jmoe.MoEConfig(**MOE_CASES[case]), moe.MoEConfig(**MOE_CASES[case])
    jp = jmoe.init_moe(jax.random.PRNGKey(7), jcfg)
    rs = np.random.RandomState(3)
    x = rs.randn(3, 24, 32).astype(f32)
    ct = rs.randn(3, 24, 32).astype(f32)
    assert moe.capacity(cfg, 24) == jmoe.capacity(jcfg, 24)

    def jloss(p, x):
        y, aux = jmoe.moe_forward(p, x, jcfg)
        return jnp.sum(y * ct) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                             has_aux=True))(jp, x)
    leaves, treedef = jax.tree.flatten(_t(jp))
    leaves = [v.requires_grad_(True) for v in leaves]
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_forward(jax.tree.unflatten(treedef, leaves), tx, cfg)
    (torch.sum(y * torch.from_numpy(ct)) + aux).backward()
    _close(y, jy, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    for g, want in zip(leaves, jax.tree.leaves(jgp)):
        _rel_close(g.grad, want, 1e-5)
    _rel_close(tx.grad, jgx, 1e-5)
    router = np.array(jp["router"])
    ids, kept = _routing(jcfg, x, router)
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(router), -1)
    np.testing.assert_array_equal(moe.top_k(probs, cfg.top_k)[1].numpy(), ids)
    if case == "drops":
        assert 0.5 < kept.mean() < 1.0


def test_top_k_breaks_ties_as_the_reference():
    """Equal probabilities: the lower expert index first, as ``lax.top_k``."""
    rs = np.random.RandomState(0)
    probs = rs.choice([0.1, 0.2, 0.3], size=(50, 8)).astype(f32)
    vals, ids = jax.lax.top_k(probs, 3)
    got_vals, got_ids = moe.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(got_vals.numpy(), np.asarray(vals))


def test_init_moe_has_the_reference_layout():
    kw = MOE_CASES["shared_raw_gates"]
    want = jmoe.init_moe(jax.random.PRNGKey(0), jmoe.MoEConfig(**kw))
    got = moe.init_moe(torch.Generator().manual_seed(0), moe.MoEConfig(**kw))
    assert jax.tree.map(lambda t: tuple(t.shape), got) == jax.tree.map(lambda a: a.shape, want)
    assert moe.MoEConfig(**kw).shared_hidden == jmoe.MoEConfig(**kw).shared_hidden == 48
