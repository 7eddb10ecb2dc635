"""The slice as a whole: the reference's LM serving against the port's.

The reference's ``lm_trainer.init_state`` builds the smoke model and its
ALPT vocab table; the reference ``LMEngine`` serves it (its kernels in
interpret mode), and ``interop`` carries the same params and table into the
port's ``LMEngine`` on the CPU.  The reference engine is a sound oracle
here: its own ``test_lm_engine_int8_resident_bitwise_vs_fp_export`` passes.

Greedy decoding turns an ulp into another token on a near-tie, so the
engines are held teacher-forced: both models are fed the port engine's
tokens and their logits agree at every step within atol 5e-5, rtol 1e-5
(fp32 sums in another order, ~5e-6 measured; tests/test_torch_lm.py).  The
token streams must be equal up to the first step whose top-1/top-2 margin
is within 10x that tolerance.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtfm
from repro.serving.lm import LMEngine as JEngine
from repro.serving.lm import LMRequest as JRequest
from repro.training import lm_trainer as jlm
from repro_torch import configs, interop
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm
from repro_torch.serving.lm import LMEngine, LMRequest
from repro_torch.training import lm_trainer

jax.config.update("jax_platform_name", "cpu")

ATOL, RTOL = 5e-5, 1e-5
MAX_LEN = 24
# (prompt length, max_new): staggered budgets free and refill slots at
# different steps, a budget of 1 finishes at prefill.
SHAPES = [(12, 6), (8, 3), (10, 5), (8, 1), (13, 4), (9, 7)]


def _setup(bits):
    jcfg = dataclasses.replace(jconfigs.smoke_config("smollm-135m"), embedding_bits=bits)
    cfg = dataclasses.replace(configs.smoke_config("smollm-135m"), embedding_bits=bits)
    tcfg = jlm.LMTrainerConfig()
    jstate = jlm.init_state(jax.random.PRNGKey(bits), jcfg, tcfg)
    jengine = JEngine.from_state(jstate, jcfg, tcfg, batch=2, max_len=MAX_LEN)
    spec = lm_trainer.embedding_spec_of(cfg)
    params = interop.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jstate.params),
                                          device="cpu")
    table = interop.quant_table_from_numpy(spec, codes=np.asarray(jengine.table.codes.data),
                                           step=np.asarray(jengine.table.step), device="cpu")
    rng = np.random.RandomState(10 + bits)
    reqs = [(rng.randint(0, cfg.vocab_size, n).astype(np.int32), g) for n, g in SHAPES]
    return jcfg, jstate.params, jengine, cfg, params, table, spec, reqs


def _engine(cfg, params, table, spec, batch=2):
    return LMEngine(params, table, cfg, spec, batch=batch, max_len=MAX_LEN)


def _serve(engine, reqs, order=None):
    order = range(len(reqs)) if order is None else order
    for i in order:
        engine.submit(LMRequest(prompt=reqs[i][0], max_new=reqs[i][1], rid=i))
    return engine.run()


def _forced(prefill_fn, decode_fn, prompt, tokens):
    """Logits [len(tokens), V] with the model fed ``prompt + tokens[:-1]``."""
    logits, cache = prefill_fn(prompt[None, :])
    out = [np.asarray(logits)[0]]
    for i, tok in enumerate(tokens[:-1]):
        logits, cache = decode_fn(np.array([tok], np.int32), cache, len(prompt) + i)
        out.append(np.asarray(logits)[0])
    return np.stack(out)


@pytest.mark.parametrize("bits", [8, 4])
def test_port_engine_matches_reference_engine(bits):
    jcfg, jparams, jengine, cfg, params, table, spec, reqs = _setup(bits)
    engine = _engine(cfg, params, table, spec)
    done = _serve(engine, reqs)
    for i, (prompt, n) in enumerate(reqs):
        jengine.submit(JRequest(prompt=prompt, max_new=n, rid=i))
    jdone = jengine.run()
    assert sorted(done) == sorted(jdone) == list(range(len(reqs)))

    jpre = jax.jit(functools.partial(jtfm.prefill, cfg=jcfg, max_len=MAX_LEN))
    jdec = jax.jit(functools.partial(jtfm.decode_step, cfg=jcfg))
    compared = 0
    for i, (prompt, n) in enumerate(reqs):
        tokens = done[i]
        assert len(tokens) == len(jdone[i]) == n
        want = _forced(lambda p: jpre(jparams, jengine.table, jnp.asarray(p)),
                       lambda t, c, cl: jdec(jparams, jengine.table, jnp.asarray(t), c,
                                             jnp.asarray(cl, jnp.int32)),
                       prompt, tokens)
        got = _forced(lambda p: tfm.prefill(params, table, torch.from_numpy(p), cfg, MAX_LEN),
                      lambda t, c, cl: tfm.decode_step(params, table, torch.from_numpy(t), c, cl,
                                                       cfg),
                      prompt, tokens)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        for step, (tok, jtok) in enumerate(zip(tokens, jdone[i])):
            if tok != jtok:
                top2 = np.sort(want[step])[-2:]
                assert top2[1] - top2[0] <= 10 * ATOL, (i, step, top2)
                break
            compared += 1
    assert compared > sum(n for _, n in reqs) // 2  # most tokens were held, not excused


@pytest.mark.parametrize("bits", [8, 4])
def test_slot_refill_determinism(bits):
    """The same requests in any arrival order -> the same tokens per request."""
    _, _, _, cfg, params, table, spec, reqs = _setup(bits)
    results = [_serve(_engine(cfg, params, table, spec), reqs, order)
               for order in (None, range(len(reqs))[::-1], [2, 3, 4, 5, 0, 1])]
    assert results[0] == results[1] == results[2]
    assert [len(results[0][i]) for i in range(len(reqs))] == [n for _, n in reqs]
    # The kernels-off switch reaches every op; on the CPU both are the plain path.
    plain = _serve(_engine(cfg, params, table, dataclasses.replace(spec, use_kernels=False)),
                   reqs)
    assert plain == results[0]


@pytest.mark.parametrize("bits,code_bytes", [(8, 512 * 48), (4, 512 * 24)])
def test_resident_bytes_are_codes_plus_scales(bits, code_bytes):
    _, _, jengine, cfg, params, table, spec, reqs = _setup(bits)
    engine = _engine(cfg, params, table, spec)
    _serve(engine, reqs[:2])
    m = engine.metrics()
    assert m.int8_resident and m.embedding_code_bytes == code_bytes
    assert m.embedding_scale_bytes == 512 * 4
    assert m.resident_embedding_bytes == code_bytes + 512 * 4 == jengine.resident_embedding_bytes
    assert m.tokens_generated == sum(n for _, n in reqs[:2]) and m.kernel_launches == {}
    j = m.to_json()
    assert j["scenario"] == "lm" and j["us_per_token"] > 0


def test_engine_rejects_oversized_and_out_of_vocab_requests():
    cfg = configs.smoke_config("smollm-135m")
    state = lm_trainer.init_state(cfg, seed=0, device="cpu")
    engine = LMEngine.from_state(state, cfg, batch=1, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        engine.submit(LMRequest(prompt=np.zeros(12, np.int32), max_new=16))
    with pytest.raises(ValueError, match="prompt tokens"):
        engine.submit(LMRequest(prompt=np.array([1, cfg.vocab_size], np.int32), max_new=2))
    # Zero generation budget: finished with an empty token list, no slot used.
    rid = engine.submit(LMRequest(prompt=np.zeros(4, np.int32), max_new=0))
    assert engine.run()[rid] == []


def test_serve_cli_lm_on_cpu(capsys):
    rc = serve.main(["lm", "--arch", "smollm-135m", "--smoke", "--device", "cpu",
                     "--requests", "5", "--gen", "6", "--prompt-len", "10", "--batch", "2"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    m = json.loads(lines[-1])
    assert lines[0].startswith("[serve] lm/alpt smollm-smoke bits=8 on cpu: 5 requests")
    assert m["scenario"] == "lm" and m["requests_completed"] == 5
    assert m["tokens_generated"] == 30 and m["kernel_launches"] == {}
    assert m["resident_embedding_bytes"] == 512 * 48 + 512 * 4 and m["int8_resident"]


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def test_lm_entry_points_refuse_cuda_without_gpu(no_gpu):
    cfg = configs.smoke_config("smollm-135m")
    with pytest.raises(RuntimeError, match="cuda"):
        lm_trainer.init_state(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["lm", "--arch", "smollm-135m", "--smoke"])
