"""The port's microbatched CTR data-parallel step against the JAX package's
``make_ctr_microbatch_step`` for every registered method, on the CPU: 2
shards, 2 steps at 32 and at 8 sync bits, the port handed the reference's
write-back and sync noise (the LM's:
tests/test_torch_data_parallel_reference.py, whose fixtures these are).

Tolerances: losses within rtol 1e-6 at 32 and 8 bits (measured <=
1.7e-7); integer tables' codes equal but for <= 1e-3 of them, float tables
and the DCN's params within 1e-5 (measured 2.4e-6: the DCN's backward sums
in another order).  The reference runs jitted with kernels off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import methods as jmethods
from repro.training import data_parallel as jdp
from repro_torch import methods
from repro_torch.training import data_parallel as dpm
from test_torch_data_parallel_reference import (
    BATCH, DATA, _ctr_pair, _np, _ref_dense_noise, _ref_leaves, _state_leaves, ref_sync_noise)


@pytest.mark.parametrize("method", methods.available())
def test_ctr_microbatched_step_against_the_reference(method):
    assert methods.available() == jmethods.available()
    for bits in (32, 8):
        jt, js, pt, ps = _ctr_pair(method, sync_bits=bits)
        jstep = jdp.make_ctr_microbatch_step(jt, 2, jdp.DPConfig(sync_bits=bits))
        pstep = dpm.make_ctr_microbatch_step(pt, 2, dpm.DPConfig(sync_bits=bits),
                                             sync_noise=ref_sync_noise)
        jl, pl = [], []
        for i in range(2):
            ids, labels = DATA.batch("train", i, BATCH)
            noise = _ref_dense_noise(method, jax.random.split(js.rng, 3)[2], js.emb_state)
            js, jm = jstep(js, jnp.asarray(ids), jnp.asarray(labels))
            ps, pm = pstep(ps, ids, labels, noise=noise)
            jl.append(float(jm["loss"]))
            pl.append(float(pm["loss"]))
        np.testing.assert_allclose(pl, jl, rtol=1e-6, err_msg=f"{method} {bits}")
        got, want = _state_leaves(pt.cfg, ps), _ref_leaves(js)
        for a, b in zip(got["dense"], want["dense"], strict=True):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-5)
        jtab = _np(jmethods.get(method).eval_table(js.emb_state, jt.spec))
        ptab = methods.get(method).eval_table(ps.emb_state, pt.spec).detach().numpy()
        if methods.get(method).is_integer_table:
            assert (jtab != ptab).mean() <= 1e-3, (method, bits)
        np.testing.assert_allclose(ptab, jtab, rtol=0, atol=1e-5, err_msg=f"{method} {bits}")
        assert ps.step == int(js.step) == 2
