"""Port parity: the DCN forward (repro_torch.models.ctr vs repro.models.ctr).

The reference's parameters are carried across as they are (``[in, out]``
MLP weights).  Logits agree at rtol=1e-5, atol=1e-6, not bitwise: the fp32
matmuls sum in another order in PyTorch than in XLA.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ctr as jctr
from repro_torch.models import ctr as pctr


def _reference(cfg_kwargs, seed):
    cfg = jctr.DCNConfig(**cfg_kwargs)
    params = jctr.init_dcn(jax.random.PRNGKey(seed), cfg)
    # Non-zero biases, so the test sees them added in the right places.
    params = jax.tree.map(lambda p: p + 0.01 if p.ndim <= 1 else p, params)
    return cfg, params


@pytest.mark.parametrize("cfg_kwargs", [
    dict(n_fields=3, emb_dim=16, cross_depth=2, mlp_widths=(32, 16)),
    dict(n_fields=4, emb_dim=15, cross_depth=3, mlp_widths=(32, 16)),
    dict(n_fields=2, emb_dim=16, cross_depth=0, mlp_widths=(8,)),
])
def test_dcn_forward_matches_reference(cfg_kwargs):
    jcfg, params = _reference(cfg_kwargs, seed=len(cfg_kwargs["mlp_widths"]))
    rows = np.random.RandomState(0).standard_normal(
        (11, jcfg.n_fields, jcfg.emb_dim)).astype(np.float32) * 0.1
    expect = np.asarray(jctr.logits_from_rows(params, jnp.asarray(rows), jcfg))
    model = pctr.DCN(pctr.DCNConfig(**cfg_kwargs)).load_jax_params(
        jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = pctr.logits_from_rows(model, torch.from_numpy(rows)).numpy()
    assert got.shape == (11,) and got.dtype == np.float32
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)


def test_jax_params_round_trip_and_shape_checks():
    jcfg, params = _reference(dict(n_fields=3, emb_dim=16, cross_depth=2,
                                   mlp_widths=(32, 16)), seed=1)
    numpy_params = jax.tree.map(np.asarray, params)
    model = pctr.DCN(pctr.DCNConfig(3, 16, 2, (32, 16))).load_jax_params(numpy_params)
    back = model.jax_params()
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(numpy_params)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pctr.DCN(pctr.DCNConfig(3, 16, 2, (32, 8))).load_jax_params(numpy_params)
    with pytest.raises(ValueError):
        pctr.DCN(pctr.DCNConfig(3, 16, 3, (32, 16))).load_jax_params(numpy_params)


def test_init_dcn_layout_and_scale():
    cfg = pctr.DCNConfig(n_fields=24, emb_dim=16)
    model = pctr.init_dcn(cfg, torch.Generator().manual_seed(0))
    shapes = [tuple(w.shape) for w in model.mlp_w]
    assert shapes == [(384, 1024), (1024, 512), (512, 256)]
    assert tuple(model.out_w.shape) == (384 + 256,)
    assert all(not b.any() for b in model.cross_b) and not model.out_b.item()
    # He-normal MLP weights: std sqrt(2 / fan_in).
    target = (2 / 384) ** 0.5
    assert abs(float(model.mlp_w[0].detach().std()) - target) < 0.01 * target
    a = pctr.init_dcn(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(a.out_w, model.out_w)


def test_bce_loss_matches_reference():
    rng = np.random.RandomState(2)
    logits = (rng.standard_normal(64) * 5).astype(np.float32)
    labels = (rng.uniform(size=64) < 0.3).astype(np.float32)
    np.testing.assert_allclose(
        pctr.bce_loss(torch.from_numpy(logits), torch.from_numpy(labels)).item(),
        float(jctr.bce_loss(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6,
    )
