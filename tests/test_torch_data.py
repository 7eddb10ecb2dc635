"""Port parity: the synthetic CTR data and the paper configs, byte for byte."""
import dataclasses

import numpy as np
import pytest

from repro.configs import dcn_ctr as jconfigs
from repro.data import ctr_synth as jsynth
from repro_torch.configs import dcn_ctr as pconfigs
from repro_torch.data import ctr_synth as psynth


@pytest.mark.parametrize("make,scale", [
    ("avazu_like", 0.01), ("criteo_like", 0.01), ("avazu_like", 0.001),
])
def test_batches_byte_equal(make, scale):
    jcfg = getattr(jsynth, make)(scale)
    pcfg = getattr(psynth, make)(scale)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(pcfg.offsets, jcfg.offsets)
    jdata, pdata = jsynth.CTRSynthetic(jcfg), psynth.CTRSynthetic(pcfg)
    for split, index in (("train", 0), ("test", 0), ("valid", 3)):
        (jids, jlab), (pids, plab) = jdata.batch(split, index, 64), pdata.batch(split, index, 64)
        assert pids.dtype == jids.dtype == np.int32
        assert pids.tobytes() == jids.tobytes() and plab.tobytes() == jlab.tobytes()


def test_full_avazu_vocabulary():
    # The full-width cell serves this table: 4,428,281 rows over 24 fields.
    cfg = psynth.avazu_like(1.0)
    assert cfg.n_features == jsynth.avazu_like(1.0).n_features == 4_428_281
    assert cfg.n_fields == 24


@pytest.mark.parametrize("setup", ["avazu_setup", "criteo_setup"])
@pytest.mark.parametrize("method,bits", [("alpt", 8), ("lpt", 4)])
def test_setups_match_reference(setup, method, bits):
    jdata, jspec, jdcn = getattr(jconfigs, setup)(method=method, bits=bits, scale=0.001)
    pdata, pspec, pdcn = getattr(pconfigs, setup)(method=method, bits=bits, scale=0.001)
    assert dataclasses.asdict(pdata) == dataclasses.asdict(jdata)
    assert dataclasses.asdict(pdcn) == dataclasses.asdict(jdcn)
    for field in ("method", "n", "d", "bits", "init_scale", "clip_value", "row_optimizer",
                  "use_kernels", "pad_to_tiles", "packed", "n_padded", "d_padded"):
        assert getattr(pspec, field) == getattr(jspec, field), field
    assert tuple(pspec.alpt) == tuple(jspec.alpt)
