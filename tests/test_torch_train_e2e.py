"""Rung 4: the port trains to the reference's accuracy, method ordering kept.

Mirrors tests/test_ctr_end2end.py: its SMALL Criteo-like dataset, 220 steps
of 256, lr 3e-3, and the same claims.  Each side draws its own init and SR
noise (torch's stream is not JAX's), so the bands are the test's tolerances:
the port's ALPT-8 AUC within 0.01 of the reference's, and the paper's
ordering (ALPT-8 ~ FP, LPT(SR) learns).
"""
import pytest

from repro.core.alpt import ALPTConfig as JALPTConfig
from repro.methods import EmbeddingSpec as JSpec
from repro.models.ctr import DCNConfig as JDCN
from repro.training import ctr_trainer as jtr
from repro_torch.core.alpt import ALPTConfig
from repro_torch.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
from repro_torch.methods import EmbeddingSpec
from repro_torch.models.ctr import DCNConfig
from repro_torch.training.ctr_trainer import CTRTrainer, TrainerConfig

SMALL = CTRDatasetConfig(name="tiny", n_fields=8,
                         cardinalities=(37, 83, 11, 199, 61, 23, 131, 17), teacher_rank=4,
                         seed=0)
DATA = CTRSynthetic(SMALL)
DCN_KW = dict(n_fields=8, emb_dim=8, cross_depth=2, mlp_widths=(64, 32))
STEPS, BATCH = 220, 256


def run_port(method, **spec_kw):
    spec = EmbeddingSpec(method=method, n=SMALL.n_features, d=8, init_scale=0.05, **spec_kw)
    tr = CTRTrainer(TrainerConfig(spec=spec, dcn=DCNConfig(**DCN_KW), lr=3e-3), device="cpu")
    state, _ = tr.fit(DATA, steps=STEPS, batch_size=BATCH)
    return tr.evaluate(state, DATA.batches("test", BATCH, 10))


@pytest.fixture(scope="module")
def results():
    ref = jtr.CTRTrainer(jtr.TrainerConfig(
        spec=JSpec(method="alpt", n=SMALL.n_features, d=8, init_scale=0.05, bits=8,
                   alpt=JALPTConfig(bits=8, step_lr=2e-4)),
        model="dcn", dcn=JDCN(**DCN_KW), lr=3e-3))
    state, _ = ref.fit(DATA, steps=STEPS, batch_size=BATCH)
    return {
        "ref_alpt8": ref.evaluate(state, DATA.batches("test", BATCH, 10)),
        "fp": run_port("fp"),
        "alpt8": run_port("alpt", bits=8, alpt=ALPTConfig(bits=8, step_lr=2e-4)),
        "lpt": run_port("lpt", bits=8, clip_value=0.1),
    }


def test_port_alpt8_auc_matches_reference(results):
    assert abs(results["alpt8"]["auc"] - results["ref_alpt8"]["auc"]) <= 0.01, results


def test_port_alpt8_close_to_port_fp(results):
    assert results["fp"]["auc"] > 0.65, results
    assert results["alpt8"]["auc"] >= results["fp"]["auc"] - 0.01, results


def test_port_lpt_sr_learns(results):
    assert results["lpt"]["auc"] > 0.60, results
    assert 0.0 < results["lpt"]["logloss"] < 0.69, results
