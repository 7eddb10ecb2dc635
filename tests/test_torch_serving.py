"""The slice as a whole: the reference's CTR serving against the port's.

JAX ``CTRTrainer.init_state`` builds the state and the JAX ``CTREngine``
serves it; ``interop.state_from_numpy`` carries the same state into the
port's ``CTREngine(device="cpu")``.  Rows are bitwise equal, the resident
byte counts exactly equal, and logits / probs agree at rtol=1e-5, atol=1e-6
(fp32 matmul summation order, as in tests/test_torch_dcn.py).  The oracle is
the reference engine itself, not its fp-export comparison
(``test_ctr_engine_int8_resident_bitwise_vs_fp_export`` fails on the
reference as it stands).
"""
import jax
import numpy as np
import pytest
import torch

from repro import methods as jmethods
from repro.data import ctr_synth as jsynth
from repro.kernels import ops as jops
from repro.models.ctr import DCNConfig as JDCNConfig
from repro.serving.ctr import CTREngine as JEngine
from repro.serving.ctr import CTRRequest as JRequest
from repro.training.ctr_trainer import CTRTrainer
from repro.training.ctr_trainer import TrainerConfig as JTrainerConfig
from repro_torch import interop
from repro_torch.data import ctr_synth as psynth
from repro_torch.methods import EmbeddingSpec
from repro_torch.models.ctr import DCNConfig
from repro_torch.serving.ctr import CTREngine, CTRRequest
from repro_torch.training.ctr_trainer import TrainerConfig, init_state

# 64 rows: a multiple of 8, so at d=16 the reference's gather and init run
# their interpreted Pallas kernels.
DATA = dict(name="t", n_fields=4, cardinalities=(13, 7, 29, 15), teacher_rank=4, seed=0)
N_REQUESTS, BATCH = 21, 8


def _pair(method, bits, d, pad_to_tiles=False):
    """(reference engine, port engine, request ids) over one shared state."""
    jdata = jsynth.CTRDatasetConfig(**DATA)
    jspec = jmethods.EmbeddingSpec(method=method, n=jdata.n_features, d=d, bits=bits,
                                   pad_to_tiles=pad_to_tiles)
    jdcn = JDCNConfig(n_fields=4, emb_dim=d, cross_depth=2, mlp_widths=(32, 16))
    trainer = CTRTrainer(JTrainerConfig(spec=jspec, dcn=jdcn))
    jstate = trainer.init_state(jax.random.PRNGKey(bits * 10 + d))
    jengine = JEngine.from_state(jstate, trainer.cfg, batch=BATCH)

    spec = EmbeddingSpec(method=method, n=jdata.n_features, d=d, bits=bits,
                         pad_to_tiles=pad_to_tiles)
    cfg = TrainerConfig(spec=spec, dcn=DCNConfig(n_fields=4, emb_dim=d, cross_depth=2,
                                                 mlp_widths=(32, 16)))
    emb = jstate.emb_state
    state = interop.state_from_numpy(
        cfg, codes=np.asarray(emb.codes.data), step=np.asarray(emb.step),
        mu=np.asarray(emb.mu), nu=np.asarray(emb.nu),
        dense_params=jax.tree.map(np.asarray, jstate.dense_params), device="cpu",
    )
    engine = CTREngine.from_state(state, cfg, batch=BATCH)
    ids, _ = psynth.CTRSynthetic(psynth.CTRDatasetConfig(**DATA)).batch("test", 0, N_REQUESTS)
    return jengine, engine, ids


@pytest.mark.parametrize("method", ["lpt", "alpt"])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("d", [16, 15])
def test_slice_matches_reference(method, bits, d):
    jengine, engine, ids = _pair(method, bits, d)
    # Rows, bitwise: the reference gathers through its interpreted kernel at
    # d=16 and through its jnp oracle at d=15.
    with jops.fallback_scope() as scope:
        jrows = np.asarray(jengine.table.rows(jax.numpy.asarray(ids)))
    assert scope.stats()["kernel_calls"].get("dequant_gather", 0) == int(d % 8 == 0)
    rows = engine.table.rows(torch.from_numpy(ids))
    np.testing.assert_array_equal(rows.numpy(), jrows)

    jrids = [jengine.submit(JRequest(ids=row)) for row in ids]
    rids = [engine.submit(CTRRequest(ids=row)) for row in ids]
    jdone, done = jengine.run(), engine.run()
    for key in ("logit", "prob"):
        np.testing.assert_allclose([done[r][key] for r in rids],
                                   [jdone[r][key] for r in jrids], rtol=1e-5, atol=1e-6)

    jm, m = jengine.metrics(), engine.metrics()
    for key in ("resident_embedding_bytes", "embedding_code_bytes",
                "embedding_scale_bytes", "int8_resident", "requests_completed", "steps"):
        assert getattr(m, key) == jm[key], key
    assert m.embedding_code_bytes + m.embedding_scale_bytes == m.resident_embedding_bytes
    # CPU tensors take the plain versions: no kernel launched.
    assert m.kernel_launches == {}


def test_slice_matches_reference_with_padded_geometry():
    jengine, engine, ids = _pair("alpt", 4, 15, pad_to_tiles=True)
    assert engine.table.codes.shape == (72, 16) and engine.table.d == 15
    np.testing.assert_array_equal(engine.table.rows(torch.from_numpy(ids)).numpy(),
                                  np.asarray(jengine.table.rows(jax.numpy.asarray(ids))))
    assert engine.resident_embedding_bytes == jengine.resident_embedding_bytes


def _small_engine(batch, method="alpt", bits=8):
    data = psynth.CTRDatasetConfig(**DATA)
    spec = EmbeddingSpec(method=method, n=data.n_features, d=16, bits=bits)
    cfg = TrainerConfig(spec=spec, dcn=DCNConfig(4, 16, 2, (32, 16)), seed=3)
    return CTREngine.from_state(init_state(cfg, device="cpu"), cfg, batch=batch), data


def test_submit_rejects_out_of_range_and_misshapen_ids():
    engine, data = _small_engine(4)
    n = data.n_features
    for bad in ([0, 1, 2, n], [-1, 0, 0, 0]):
        with pytest.raises(ValueError, match=r"\[0, 64\)"):
            engine.submit(CTRRequest(ids=np.array(bad, np.int32)))
    with pytest.raises(ValueError, match="shape"):
        engine.submit(CTRRequest(ids=np.zeros(3, np.int32)))
    assert engine.pending == 0
    rid = engine.submit(CTRRequest(ids=np.array([0, 1, 2, n - 1], np.int32)))
    assert engine.poll(rid) is None and engine.pending == 1
    engine.run()
    assert 0.0 < engine.poll(rid)["prob"] < 1.0 and engine.pending == 0


def test_results_independent_of_wave_and_padding():
    ids, _ = psynth.CTRSynthetic(psynth.CTRDatasetConfig(**DATA)).batch("test", 1, 11)
    out = []
    for batch in (1, 4, 16):
        engine, _ = _small_engine(batch)
        rids = [engine.submit(CTRRequest(ids=row)) for row in ids]
        done = engine.run()
        assert engine.metrics().steps == -(-11 // batch)
        out.append([done[r]["prob"] for r in rids])
    assert out[0] == out[1] == out[2]


def test_metrics_schema_and_float_table():
    engine, _ = _small_engine(8, bits=4)
    engine.submit(CTRRequest(ids=np.array([1, 2, 3, 4], np.int32)))
    engine.run()
    m = engine.metrics().to_json()
    assert m["int8_resident"] and m["requests_completed"] == 1 and m["us_per_request"] > 0
    assert m["embedding_code_bytes"] == 64 * 8 and m["embedding_scale_bytes"] == 64 * 4
    fp_engine, _ = _small_engine(8, method="fp")
    fp_engine.submit(CTRRequest(ids=np.array([1, 2, 3, 4], np.int32)))
    fp_engine.run()
    fm = fp_engine.metrics()
    assert not fm.int8_resident and fm.resident_embedding_bytes == 64 * 16 * 4
    assert fm.embedding_code_bytes == 0


def test_engine_rejects_mixed_devices():
    engine, _ = _small_engine(2)
    meta = torch.nn.Linear(1, 1, device="meta")
    with pytest.raises(ValueError, match="dense params"):
        CTREngine(meta, engine.table, engine.model_cfg, engine.spec, batch=2)
    with pytest.raises(ValueError, match="batch"):
        CTREngine(engine.dense, engine.table, engine.model_cfg, engine.spec, batch=0)
