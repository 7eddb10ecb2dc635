"""The port's spec builders against the JAX package's (repro/dist/sharding.py,
repro/dist/context.py), exactly, and its explicit shards.

Spec builders are pure functions of shapes: for every arch of the registry
at its full config (shapes only: meta tensors in the port, ``eval_shape``
in the reference), the policies tp, tp_sp, fsdp_tp, fsdp_tp_ep and dp, and
model axes of 1, 2 and 16, the port's ``param_pspecs``, ``state_pspecs``,
every method's ``table_pspecs`` / ``param_pspec``, ``batch_pspecs``,
``cache_pspecs`` and the context's ``_spec_for`` equal the reference's,
each ``PartitionSpec`` read as its tuple of entries.  One parametrised test,
a case per arch x policy x model size.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro import methods as jmethods
from repro.dist import context as jctx
from repro.dist import sharding as jsh
from repro.training import lm_trainer as jlm
from repro_torch import configs, methods
from repro_torch.core.codestore import CodeStore
from repro_torch.dist import context, sharding
from repro_torch.launch.mesh import HostMesh
from repro_torch.optim import tree_leaves

jax.config.update("jax_platform_name", "cpu")
POLICIES = ("tp", "tp_sp", "fsdp_tp", "fsdp_tp_ep", "dp")
MODEL_SIZES = (1, 2, 16)
KINDS = ("q_heads", "kv_heads", "carry", "activation", "head_weight", "embed_table", "logits",
         "moe_buf")


def _norm(x):
    """A spec tree in one form for both packages: a spec as ``("P",
    entries)``, a NamedTuple as its type name and fields."""
    if isinstance(x, (sharding.P, jax.sharding.PartitionSpec)):
        return ("P", tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in x))
    if hasattr(x, "_fields"):
        return (type(x).__name__, {f: _norm(getattr(x, f)) for f in x._fields})
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    assert x is None, x
    return None


def _state(x):
    """A state spec's fields, the reference's ``rng`` as the port's ``generator``."""
    fields = {("generator" if f == "rng" else f): _norm(getattr(x, f)) for f in x._fields}
    return fields


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    jcfg = jconfigs.full_config(arch)
    jstate = jax.eval_shape(functools.partial(jlm.init_state, cfg=jcfg, tcfg=jlm.LMTrainerConfig()),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    return jstate, sharding.param_shapes(configs.full_config(arch))


def _mesh(model):
    return types.SimpleNamespace(shape={"data": 4, "model": model})


@pytest.mark.parametrize("model", MODEL_SIZES)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_spec_builders_equal_the_reference(arch, policy, model):
    jcfg, cfg = jconfigs.full_config(arch), configs.full_config(arch)
    jstate, pshapes = _shapes(arch)
    jpol = jsh.default_policy(arch, model_size=model, override=policy)
    pol = sharding.default_policy(arch, model_size=model, override=policy)
    assert dataclasses.asdict(pol) == dataclasses.asdict(jpol)
    assert pol.dp_spec == jpol.dp_spec
    mesh = _mesh(model)

    assert _norm(sharding.param_pspecs(cfg, pol, pshapes)) == _norm(
        jsh.param_pspecs(jcfg, jpol, jstate.params))
    jt, pt = jlm.LMTrainerConfig(), None
    assert _state(sharding.state_pspecs(cfg, pol, pt, pshapes)) == _state(
        jsh.state_pspecs(jcfg, jpol, jt, jstate))
    assert sharding._table_axes(cfg, pol) == jsh._table_axes(jcfg, jpol)
    for name in methods.available():
        jc = dataclasses.replace(jcfg, embedding_method=name)
        c = dataclasses.replace(cfg, embedding_method=name)
        for opt in ("adam", "adagrad"):
            assert _norm(sharding.table_pspecs(c, pol, opt)) == _norm(
                jsh.table_pspecs(jc, jpol, opt)), (name, opt)
        axes = jsh._table_axes(jcfg, jpol)
        assert _norm(methods.get(name).param_pspec(*axes)) == _norm(
            jmethods.get(name).param_pspec(*axes)), name

    for b in (8, 6):
        batch = {"tokens": torch.empty(b, 64), "labels": torch.empty(b, 64),
                 "positions": torch.empty(3, b, 64), "prefix_embeds": torch.empty(b, 16, 32)}
        jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32) for k, v in batch.items()}
        assert _norm(sharding.batch_pspecs(batch, cfg, pol, mesh)) == _norm(
            jsh.batch_pspecs(jbatch, jcfg, jpol, mesh))
        assert _norm(sharding.cache_pspecs(cfg, pol, b, mesh)) == _norm(
            jsh.cache_pspecs(jcfg, jpol, b, mesh))
    h, kv = cfg.padded_heads
    shapes = [(8, 64, h, cfg.hd), (6, 64, kv, cfg.hd), (8, 64, cfg.d_model), (8, 63, cfg.d_model),
              (cfg.vocab_size, cfg.d_model), (8, 32, cfg.vocab_size), (8, 8, 32, cfg.d_model),
              (5,), (8, 32, 2, 7)]
    for kind in KINDS:
        for shape in shapes:
            assert _norm(context._spec_for(kind, shape, pol, mesh)) == _norm(
                jctx._spec_for(kind, shape, jpol, mesh)), (kind, shape)
    with pytest.raises(ValueError, match="unknown sharding hint kind"):
        context._spec_for("nope", (1,), pol, mesh)
    if arch == "hubert-xlarge" and model == 16:  # 504 rows do not split 16 ways
        assert sharding.param_pspecs(cfg, pol, pshapes)["head"] == sharding.P(None, "model")


def test_shards_of_every_rank_put_back_the_whole_tree():
    """``shard_tree`` at every coordinate of a 2 x 2 mesh: the blocks, put
    together along their specs, are each leaf bitwise (packed codes cut on
    byte boundaries); ``P`` prints as the reference's spec."""
    cfg = dataclasses.replace(configs.smoke_config("qwen3-1.7b"), embedding_bits=4)
    g = torch.Generator().manual_seed(0)
    from repro_torch.models import transformer as tfm
    from repro_torch.training import lm_trainer

    params = tfm.init_params(g, cfg)
    spec = lm_trainer.embedding_spec_of(cfg)
    table = methods.get(spec.method).init(g, spec)
    pol = sharding.policy_from_name("tp", model_size=2)
    pspecs = sharding.param_pspecs(cfg, pol)
    for row, col in (("model", None), (None, "model")):
        tspecs = methods.get(spec.method).table_pspec(row, col)
        blocks = {}
        for d in range(2):
            for m in range(2):
                mesh = HostMesh(shape={"data": 2, "model": 2}, coords={"data": d, "model": m},
                                groups={"data": None, "model": None})
                blocks[d, m] = (sharding.shard_tree(params, pspecs, mesh),
                                sharding.shard_tree(table, tspecs, mesh))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(blocks[0, 1][0]),
                                                     tree_leaves(blocks[1, 1][0])))
        for whole, spec_, parts in zip(tree_leaves(params), sharding.spec_leaves(pspecs),
                                       zip(*(tree_leaves(blocks[0, m][0]) for m in range(2)))):
            dims = [i for i, e in enumerate(spec_) if e == "model"]
            got = torch.cat(parts, dim=dims[0]) if dims else parts[0]
            assert torch.equal(got, whole)
        codes = [blocks[0, m][1].codes for m in range(2)]
        assert all(isinstance(c, CodeStore) for c in codes)
        dim = 0 if row else 1
        assert torch.equal(torch.cat([c.data for c in codes], dim=dim), table.codes.data)
        assert torch.equal(torch.cat([c.unpack() for c in codes], dim=dim),
                           table.codes.unpack())
        step = [blocks[0, m][1].step for m in range(2)]
        assert torch.equal(torch.cat(step) if row else step[0], table.step)
    assert repr(sharding.P("model", None)) == "P('model', None)"
    assert repr(sharding.P(("pod", "data"), None)) == "P(('pod', 'data'), None)"


def test_hint_is_the_identity_and_checks_its_kind():
    mesh = HostMesh(shape={"data": 1, "model": 2}, coords={"data": 0, "model": 0},
                    groups={"data": None, "model": None})
    x = torch.ones(2, 4, 3)
    assert context.hint(x, "carry") is x
    with context.use(mesh, sharding.policy_from_name("tp_sp", model_size=2)) as ctx:
        assert context.current() is ctx and context.moe_ep_context() is None
        assert context.hint(x, "carry") is x
        assert context.spec_of("carry", (2, 4, 3)) == sharding.P(None, "model", None)
        with pytest.raises(ValueError):
            context.hint(x, "nope")
    assert context.current() is None


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_packed_shards_split_on_byte_boundaries(bits):
    """The step splits a packed table over d only where a shard's codes fill
    whole bytes: no arch of the registry at model 2 or 16 loses the split
    (hubert's 504-row table on 16 is split over d, 80 codes a shard); a width
    of 34 on 2 ranks (17 codes) does, and its table is replicated."""
    from repro_torch.training import lm_trainer

    for arch in configs.ARCHS:
        for model in (2, 16):
            cfg = dataclasses.replace(configs.full_config(arch), embedding_bits=bits)
            pol = sharding.policy_from_name("tp", model_size=model)
            spec = lm_trainer.embedding_spec_of(cfg)
            assert lm_trainer._table_axes(cfg, spec, pol) == sharding._table_axes(cfg, pol)
    cfg = dataclasses.replace(configs.smoke_config("qwen3-1.7b"), vocab_size=509, d_model=34,
                              embedding_bits=bits)
    pol = sharding.policy_from_name("tp", model_size=2)
    spec = lm_trainer.embedding_spec_of(cfg)
    want = (None, "model") if bits == 8 else (None, None)
    assert sharding._table_axes(cfg, pol) == (None, "model")
    assert lm_trainer._table_axes(cfg, spec, pol) == want
