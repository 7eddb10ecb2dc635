"""The port's LR schedules, SGD and the LM step's ``lr_schedule`` hook
(repro_torch/optim/schedule.py, optim/adam.py, training/lm_trainer.py,
training/data_parallel.py) against the JAX package's jitted ones.

A schedule is held at host steps against the reference's function jitted
on an int32 scalar step, as its train step evaluates it.  The port computes
the arithmetic XLA:CPU compiles (the module docstring of the port's
schedule lists the rewrites): the constant and the warmup's linear part
are bitwise.  XLA's ``rsqrt`` and ``cos`` are approximations within an ulp
of the correctly rounded values the port takes, and which arguments they
miss depends on the host's XLA build, so

* ``inv_sqrt``'s ``lr * rsqrt(s)`` is held within 2 ulps (one of
  ``rsqrt``, one of the product's rounding);
* ``cosine``'s ``lr * (f + (1 - f) / 2 * (1 + cos))`` within one float32
  spacing of ``lr``: an ulp of ``cos`` (at most 2^-24) times ``(1 - f) / 2
  * lr``, which the last rounding can carry to the next float.

SGD's step is bitwise, and a scheduled LM step is bitwise the constant-lr
step at the schedule's value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import adam as jadam
from repro.optim import schedule as jsched
from repro_torch import configs, optim
from repro_torch.data.lm_synth import LMTokenStream
from repro_torch.optim import schedule as psched
from repro_torch.training import data_parallel as dpm
from repro_torch.training import lm_trainer

jax.config.update("jax_platform_name", "cpu")
LR, WARMUP, TOTAL, FINAL = 3e-4, 37, 777, 0.05


def _ref_at(fn, steps):
    jitted = jax.jit(fn)
    return np.array([np.asarray(jitted(jnp.int32(s))) for s in steps], dtype=np.float32)


def _port_at(fn, steps):
    return np.array([fn(s) for s in steps], dtype=np.float32)


def _steps(warmup, total):
    """0, 1, 2, the step before and at ``warmup``, ``total`` and past it."""
    return sorted({0, 1, 2, max(warmup - 1, 0), warmup, total, total + 1, 2 * total + 5})


SCHEDULES = {
    "constant": (jsched.constant_schedule(LR), psched.constant_schedule(LR), 0),
    "inv_sqrt": (jsched.inv_sqrt_schedule(LR), psched.inv_sqrt_schedule(LR), 0),
    "cosine": (jsched.cosine_schedule(LR, TOTAL, FINAL), psched.cosine_schedule(LR, TOTAL, FINAL),
               0),
    "warmup_cosine": (jsched.warmup_cosine_schedule(LR, WARMUP, TOTAL, FINAL),
                      psched.warmup_cosine_schedule(LR, WARMUP, TOTAL, FINAL), WARMUP),
}


def _check(name, want, got):
    if name == "constant":
        np.testing.assert_array_equal(got, want)
    elif name == "inv_sqrt":
        np.testing.assert_array_max_ulp(got, want, maxulp=2)
    else:
        assert np.abs(got.astype(np.float64) - want).max() <= np.spacing(np.float32(LR))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_the_jitted_reference(name):
    """At 0, 1, 2, either side of the warmup, at ``total_steps`` and past it,
    and over a sweep of 0..511, within the module docstring's tolerance;
    float32 values throughout."""
    ref, port, warmup = SCHEDULES[name]
    steps = _steps(warmup, TOTAL)
    _check(name, _ref_at(ref, steps), _port_at(port, steps))
    sweep = range(512)
    _check(name, _ref_at(ref, sweep), _port_at(port, sweep))
    assert all(np.float32(port(s)) == port(s) for s in steps)


def test_warmup_is_bitwise_and_edges_hold():
    """The warmup's ``s * f32(lr / warmup)`` bitwise at every warmup step;
    the cosine's ends bitwise (``cos(0) = 1``; past the end ``t`` clips at
    1); ``warmup = 0`` starts on the cosine; ``inv_sqrt`` at steps 0 and 1
    is ``lr``."""
    ref, port, _ = SCHEDULES["warmup_cosine"]
    np.testing.assert_array_equal(_port_at(port, range(WARMUP)), _ref_at(ref, range(WARMUP)))
    ends = [WARMUP, TOTAL, TOTAL + 1, 5 * TOTAL]
    np.testing.assert_array_equal(_port_at(port, ends), _ref_at(ref, ends))
    for lr, w in ((1e-3, 0), (7e-3, 100), (0.1, 1)):
        r = jsched.warmup_cosine_schedule(lr, w, 1000, 0.1)
        p = psched.warmup_cosine_schedule(lr, w, 1000, 0.1)
        np.testing.assert_array_equal(_port_at(p, range(w + 2)), _ref_at(r, range(w + 2)))
    inv = SCHEDULES["inv_sqrt"][1]
    assert inv(0) == inv(1) == float(np.float32(LR))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_sgd_update_is_bitwise_the_jitted_reference(weight_decay):
    """``fma(-lr, g, p)``, with decay ``fma(-lr, fma(wd, p, g), p)``: every
    element bitwise, two steps; the step counter counts, no moments."""
    rng = np.random.default_rng(3)
    params = [rng.standard_normal((64, 33)).astype(np.float32),
              (rng.standard_normal(129) * 3).astype(np.float32)]
    grads = [(rng.standard_normal(p.shape) * 1e-2).astype(np.float32) for p in params]
    jupd = jax.jit(lambda g, s, p: jadam.sgd_update(g, s, p, 0.37, weight_decay=weight_decay))
    js, ps = jadam.sgd_init(params), optim.sgd_init(None)
    jp, pp = params, [torch.from_numpy(p) for p in params]
    for _ in range(2):
        jp, js = jupd(grads, js, jp)
        pp, ps = optim.sgd_update([torch.from_numpy(g) for g in grads], ps, pp, 0.37,
                                  weight_decay=weight_decay)
        for a, b in zip(jp, pp):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert ps.step == int(js.step) == 2 and ps.mu == ps.nu == ()


def test_make_optimizer_names_and_error():
    """'adam' and 'adamw' give Adam, 'sgd' SGD, as the reference's; another
    name raises ``ValueError`` in both."""
    assert optim.make_optimizer("adam") == optim.make_optimizer("adamw") == (
        optim.adam_init, optim.adam_update)
    assert optim.make_optimizer("sgd") == (optim.sgd_init, optim.sgd_update)
    for make in (jadam.make_optimizer, optim.make_optimizer):
        with pytest.raises(ValueError, match="unknown optimizer"):
            make("rmsprop")


def _smoke():
    cfg = configs.smoke_config("smollm-135m")
    data = torch.from_numpy(LMTokenStream(cfg.vocab_size, 32, seed=17).batch(0, 4))
    return cfg, {"tokens": data[:, :-1], "labels": data[:, 1:]}


def _same(a, b):
    la = optim.tree_leaves(a.params) + a.opt.mu + a.opt.nu
    lb = optim.tree_leaves(b.params) + b.opt.mu + b.opt.nu
    return (all(torch.equal(x, y) for x, y in zip(la, lb, strict=True))
            and torch.equal(a.table.codes.data, b.table.codes.data)
            and torch.equal(a.table.step, b.table.step))


def _constant_step(make, tcfg, sched, state, batch):
    """The step made at the constant lr the schedule gives the state's step."""
    state, m = make(dataclasses.replace(tcfg, lr=sched(state.step)))(state, batch)
    assert m["lr"] == sched(state.step - 1)
    return state


def _at_step(cfg, tcfg, step):
    """The smoke init with its step counter at ``step``."""
    return lm_trainer.init_state(cfg, tcfg, seed=0, device="cpu")._replace(step=step)


def test_scheduled_train_step_is_the_constant_step_at_its_value():
    """``make_train_step(cfg, tcfg, lr_schedule)``: two ALPT-8 steps of the
    smoke SmolLM bitwise two constant-lr steps at ``cosine(0)`` and
    ``cosine(1)``; ``make_lm_microbatch_step``'s step at step 1 bitwise its
    constant-lr step at ``cosine(1)``."""
    cfg, batch = _smoke()
    tcfg = lm_trainer.LMTrainerConfig(lr=1e-3)
    sched = psched.cosine_schedule(1e-3, 3)
    assert sched(0) != sched(1) != float(np.float32(tcfg.lr))
    state, want = _at_step(cfg, tcfg, 0), _at_step(cfg, tcfg, 0)
    step = lm_trainer.make_train_step(cfg, tcfg, sched)
    for i in range(2):
        state, m = step(state, batch)
        assert m["lr"] == sched(i)
        want = _constant_step(lambda t: lm_trainer.make_train_step(cfg, t), tcfg, sched, want,
                              batch)
    assert _same(state, want)
    state, m = dpm.make_lm_microbatch_step(cfg, tcfg, 2, lr_schedule=sched)(
        _at_step(cfg, tcfg, 1), batch)
    assert m["lr"] == sched(1)
    want = _constant_step(lambda t: dpm.make_lm_microbatch_step(cfg, t, 2), tcfg, sched,
                          _at_step(cfg, tcfg, 1), batch)
    assert _same(state, want)


def test_dp_step_passes_the_schedule_through(tmp_path):
    """``make_lm_dp_step(..., lr_schedule=)`` on a one-rank gloo group: its
    step at step 1 takes the schedule's lr, its state the constant-lr
    step's."""
    cfg, batch = _smoke()
    tcfg = lm_trainer.LMTrainerConfig(lr=1e-3)
    sched = psched.inv_sqrt_schedule(1e-3)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init", rank=0, world_size=1)
    try:
        state, m = dpm.make_lm_dp_step(cfg, tcfg, dist.group.WORLD, lr_schedule=sched)(
            _at_step(cfg, tcfg, 2), batch)
        assert m["lr"] == sched(2) != float(np.float32(tcfg.lr))
        want = _constant_step(lambda t: dpm.make_lm_dp_step(cfg, t, dist.group.WORLD), tcfg,
                              sched, _at_step(cfg, tcfg, 2), batch)
        assert _same(state, want)
    finally:
        dist.destroy_process_group()
