"""Port parity for DeepFM and DCN dropout (rung 3: through fp32 matmuls).

The reference's parameters are carried across as they are, and its dropout
masks, the ``bernoulli`` draws of the ``split`` chain of ``dropout_key`` in
``dcn_forward`` / ``deepfm_forward``, are handed to the port as an
operand.  Logits and gradients agree at rtol=1e-5, atol=1e-6 (the matmuls
sum in another order than XLA's); the trainers' losses over 5 steps with
dropout 0.2 (DeepFM + ALPT, DeepFM + LSQ, DCN + fp), fed the reference's
masks and SR noise, at rtol=1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
from repro.methods import EmbeddingSpec as JSpec
from repro.models import ctr as jctr
from repro.training import ctr_trainer as jtr
from repro_torch import interop
from repro_torch.methods import EmbeddingSpec as PSpec
from repro_torch.models import ctr as pctr
from repro_torch.training import ctr_trainer as ptr

TOL = dict(rtol=1e-5, atol=1e-6)


def reference_masks(key, batch, widths, dropout):
    """The keep-masks ``dcn_forward`` / ``deepfm_forward`` draw from
    ``dropout_key``: one ``split`` per MLP layer, ``bernoulli(sub, 1 - p)``."""
    masks = []
    for w in widths:
        key, sub = jax.random.split(key)
        masks.append(torch.from_numpy(np.array(jax.random.bernoulli(sub, 1.0 - dropout,
                                                                    (batch, w)))))
    return masks


def _with_biases(params):
    return jax.tree.map(lambda p: p + 0.01 if p.ndim <= 1 else p, params)


@pytest.mark.parametrize("model,dropout", [("dcn", 0.2), ("deepfm", 0.0), ("deepfm", 0.2)])
def test_forward_and_backward_with_reference_masks(model, dropout):
    f, d, b, widths = 5, 16, 13, (32, 24)
    if model == "dcn":
        jcfg = jctr.DCNConfig(n_fields=f, emb_dim=d, cross_depth=2, mlp_widths=widths,
                              dropout=dropout)
        params = _with_biases(jctr.init_dcn(jax.random.PRNGKey(1), jcfg))
        pmodel = pctr.DCN(pctr.DCNConfig(f, d, 2, widths, dropout))
        width = d
    else:
        jcfg = jctr.DeepFMConfig(n_fields=f, emb_dim=d, mlp_widths=widths, dropout=dropout)
        params = _with_biases(jctr.init_deepfm(jax.random.PRNGKey(1), jcfg))
        pmodel = pctr.DeepFM(pctr.DeepFMConfig(f, d, widths, dropout))
        width = d + 1  # the odd width: the last column is the first-order weight
    pmodel.load_jax_params(jax.tree.map(np.asarray, params))
    rows = (np.random.RandomState(0).randn(b, f, width) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def jloss(p, r):
        return jnp.sum(jctr.logits_from_rows(p, r, jcfg, model=model, dropout_key=key) ** 2)

    jlogits = np.asarray(jax.jit(lambda p, r: jctr.logits_from_rows(
        p, r, jcfg, model=model, dropout_key=key))(params, jnp.asarray(rows)))
    jg_p, jg_r = jax.jit(jax.grad(jloss, (0, 1)))(params, jnp.asarray(rows))
    masks = reference_masks(key, b, widths, dropout) if dropout else None
    trows = torch.from_numpy(rows).requires_grad_(True)
    logits = pctr.logits_from_rows(pmodel, trows, masks)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, **TOL)
    grads = torch.autograd.grad(torch.sum(logits ** 2), [trows, *pmodel.parameters()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg_r), **TOL)
    # Parameter gradients in parameters() order against the reference's
    # pytree, laid out through the module's own loader.
    module = type(pmodel)(pmodel.cfg)
    module.load_jax_params(jax.tree.map(np.asarray, jg_p))
    for g, want in zip(grads[1:], module.parameters()):
        np.testing.assert_allclose(g.numpy(), want.detach().numpy(), **TOL)
    if dropout:  # the masks really drop units
        assert not all(bool(m.all()) for m in masks)
        with torch.no_grad():
            eval_logits = pctr.logits_from_rows(pmodel, trows)
        assert not torch.allclose(eval_logits, logits)


def test_deepfm_jax_params_round_trip_and_init_distributions():
    cfg = pctr.DeepFMConfig(n_fields=24, emb_dim=16)
    model = pctr.init_deepfm(cfg, torch.Generator().manual_seed(0))
    assert [tuple(w.shape) for w in model.mlp_w] == [(384, 400), (400, 400), (400, 400)]
    assert abs(float(model.mlp_w[0].detach().std()) - (2.0 / 384) ** 0.5) < 0.01
    back = pctr.DeepFM(cfg).load_jax_params(model.jax_params())
    for a, b in zip(back.parameters(), model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        pctr.DeepFM(pctr.DeepFMConfig(n_fields=2, emb_dim=16)).load_jax_params(model.jax_params())


DATA_CFG = CTRDatasetConfig(name="t", n_fields=6, cardinalities=(40, 9, 300, 17, 5, 100),
                            teacher_rank=4)
DATA = CTRSynthetic(DATA_CFG)


@pytest.mark.parametrize("model,method", [("deepfm", "alpt"), ("deepfm", "lsq"), ("dcn", "fp")])
def test_trainer_losses_match_reference_with_dropout(model, method):
    """5 steps from the reference's initial state, fed its dropout masks and
    SR noise: losses at rtol=1e-5 (DeepFM: table width d + 1 = 9; ALPT's
    second forward reuses the step's masks)."""
    d, widths, p = 8, (32, 16), 0.2
    kw = dict(method=method, n=DATA_CFG.n_features, d=d + (model == "deepfm"), bits=8,
              init_scale=0.05)
    if model == "dcn":
        jm = dict(dcn=jctr.DCNConfig(6, d, 2, widths, p))
        pm = dict(dcn=pctr.DCNConfig(6, d, 2, widths, p))
    else:
        jm = dict(deepfm=jctr.DeepFMConfig(6, d, widths, p))
        pm = dict(deepfm=pctr.DeepFMConfig(6, d, widths, p))
    jt = jtr.CTRTrainer(jtr.TrainerConfig(spec=JSpec(**kw), model=model, lr=3e-3, **jm))
    pcfg = ptr.TrainerConfig(spec=PSpec(**kw), model=model, lr=3e-3, **pm)
    pt = ptr.CTRTrainer(pcfg, device="cpu")
    js = jt.init_state()
    emb = js.emb_state
    if method == "alpt":
        state_kw = dict(codes=np.asarray(emb.codes.data), step=np.asarray(emb.step),
                        mu=np.asarray(emb.mu), nu=np.asarray(emb.nu), count=int(emb.count))
    else:
        state_kw = {"emb_state": jax.tree.map(np.asarray, emb._asdict() if method == "lsq"
                                              else emb)}
    ps = interop.state_from_numpy(pcfg, dense_params=jax.tree.map(np.asarray, js.dense_params),
                                  device="cpu", **state_kw)
    jl, pl = [], []
    for i in range(5):
        ids, labels = DATA.batch("train", i, 64)
        noise = None
        if method != "alpt":  # float leaves: the reference splits (rng, kd)
            masks = reference_masks(jax.random.split(js.rng)[1], 64, widths, p)
        else:  # integer tables: (rng, kd, kn)
            kd, kn = jax.random.split(js.rng, 3)[1:]
            masks = reference_masks(kd, 64, widths, p)
            noise = [torch.from_numpy(np.array(jq.sr_noise(k, (ids.size, kw["d"]))))
                     for k in (kn, jax.random.fold_in(kn, 1))]
        js, jmet = jt.train_step(js, ids, labels)
        ps, pmet = pt.train_step(ps, ids, labels, masks=masks, noise=noise)
        jl.append(float(jmet["loss"]))
        pl.append(float(pmet["loss"]))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert len(set(pl)) == 5
