"""The port's data parallelism (``repro_torch.dist.collectives``,
``repro_torch.training.data_parallel``, the ``train lm`` CLI's
``--mesh-data`` / ``--dp-compress-bits``) on the CPU: the collectives
against the JAX package's, the n-rank steps against their one-process twins
over gloo, and the CLI.  tests/test_torch_data_parallel_reference.py holds
the trainers' pieces and microbatched steps against the reference's.

- The stacked twins, bitwise against the reference's jitted ones on the
  same stack, the port handed the reference's noise (``sr_noise(fold_in(key,
  rank))``), at 32, 8, 4, 3 and 2 bits and 2, 3 and 4 ranks (rung 1).
- The wire-byte accounting equal to the reference's; ``DPConfig``'s widths.
- ``make_ctr_dp_step`` / ``make_lm_dp_step`` on 2 and 4 gloo processes,
  bitwise against each rank's ``make_*_microbatch_step`` with ``n_shards``
  = the ranks, at 32, 8, 4 and 2 bits, every rank the same state.
- The CLI: ``--mesh-data 2`` under ``torch.distributed.run`` bitwise the
  twin's losses, SIGTERM on one rank stopping both at the same step, a
  resume at another ``--mesh-data``, and the reference's checks' errors.

Multi-process groups start from a file in the test's directory, never a
fixed port, and every process has a timeout.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.dist import collectives as jcoll
from repro_torch import configs, methods
from repro_torch.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
from repro_torch.data.lm_synth import LMTokenStream
from repro_torch.dist import collectives
from repro_torch.launch import train as train_cli
from repro_torch.models import ctr as pctr
from repro_torch.optim import tree_leaves
from repro_torch.training import ctr_trainer as ptr
from repro_torch.training import data_parallel as dpm
from repro_torch.training import lm_trainer

jax.config.update("jax_platform_name", "cpu")
REPO = pathlib.Path(__file__).resolve().parent.parent
f32 = np.float32
# The reference test's mini size (tests/test_data_parallel.py).
CARDS = (17, 29, 11, 41, 13, 23)
DCN_KW = dict(n_fields=6, emb_dim=8, cross_depth=2, mlp_widths=(32, 16))
DATA = CTRSynthetic(CTRDatasetConfig(name="mini", n_fields=6, cardinalities=CARDS,
                                     teacher_rank=4, seed=3))
N_FEATURES = sum(CARDS)
BATCH = 64


def _np(x):
    return np.array(x)


# ---------------------------------------------------------------- (a) fast


@pytest.mark.parametrize("bits", [32, 8, 6, 4, 3, 2])
def test_wire_bytes_match_the_reference(bits):
    shapes = [(1000, 16), (64, 32), (33,), ()]
    ref = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    assert collectives.sync_wire_bytes(shapes, bits) == jcoll.sync_wire_bytes(ref, bits)
    assert collectives.sync_compression_ratio(shapes, bits) == jcoll.sync_compression_ratio(
        ref, bits)
    n_elem = 1000 * 16 + 64 * 32 + 33 + 1
    assert collectives.sync_wire_bytes(shapes, 32) == n_elem * 4
    report = dpm.wire_report([torch.zeros(s) for s in shapes], bits)
    assert report["wire_bytes_per_step"] == jcoll.sync_wire_bytes(ref, bits)
    assert report["fp32_wire_bytes_per_step"] == n_elem * 4


def test_wire_bytes_and_dp_config_refuse_other_widths():
    with pytest.raises(ValueError):
        collectives.sync_wire_bytes([(4, 4)], 16)
    for bits in (32, 8, 4, 2):
        assert dpm.DPConfig(sync_bits=bits).sync_bits == bits
    for bits in (16, 1, 9, 0):
        with pytest.raises(ValueError):
            dpm.DPConfig(sync_bits=bits)
    assert dpm.DPConfig().sync_bits == 32 and dpm.DPConfig().use_kernels


def test_keyed_noise_is_keyed_by_every_part_of_its_path():
    draw = dpm.keyed_noise(3)
    base = draw((1, 2), 0, (5, 4), torch.device("cpu"))
    assert torch.equal(base, draw((1, 2), 0, (5, 4), torch.device("cpu")))
    for other in (((1, 3), 0), ((2, 2), 0), ((1, 2), 1), ((1, 2, 0), 0)):
        assert not torch.equal(base, draw(*other, (5, 4), torch.device("cpu")))
    assert not torch.equal(base, dpm.keyed_noise(4)((1, 2), 0, (5, 4), torch.device("cpu")))
    assert float(base.min()) >= 0.0 and float(base.max()) < 1.0


# ---------------------------------------------------- (b) rung 1: collectives


@pytest.mark.parametrize("bits", [32, 8, 4, 3, 2])
def test_stacked_twins_bitwise_against_the_reference(bits):
    """At 2, 3 and 4 ranks (3: the mean's reciprocal is not exact), over a
    table-shaped, a 1-D and a scalar leaf."""
    rs = np.random.RandomState(bits)
    key = jax.random.PRNGKey(11)
    shapes = ((32, 8), (40,), ())
    for n in (2, 3, 4):
        stacks = tuple((rs.randn(n, *s) * np.exp(rs.randn(n, *s))).astype(f32) for s in shapes)
        if bits == 32:
            want = jax.jit(lambda st: [jcoll.exact_pmean_stacked(x) for x in st])(stacks)
            for stack, w in zip(stacks, want):
                got = collectives.exact_pmean_stacked(torch.from_numpy(stack))
                np.testing.assert_array_equal(got.numpy(), _np(w))
            continue
        want = jax.jit(lambda st: [(jcoll.compressed_psum_stacked(x, key, bits=bits),
                                    jcoll.compressed_pmean_stacked(x, key, bits=bits))
                                   for x in st])(stacks)
        for stack, shape, (w_sum, w_mean) in zip(stacks, shapes, want):
            noise = [torch.from_numpy(_np(jq.sr_noise(jax.random.fold_in(key, r), shape)))
                     for r in range(n)]
            for use_kernels in (False, True):
                t = torch.from_numpy(stack)
                got_sum = collectives.compressed_psum_stacked(t, noise, bits, use_kernels)
                got_mean = collectives.compressed_pmean_stacked(t, noise, bits, use_kernels)
                assert got_sum.shape == got_mean.shape == w_sum.shape
                np.testing.assert_array_equal(got_sum.numpy(), _np(w_sum), err_msg=f"{n} {shape}")
                np.testing.assert_array_equal(got_mean.numpy(), _np(w_mean),
                                              err_msg=f"{n} {shape}")
            # Unbiased: the compressed mean within one step of the exact one.
            step = np.abs(stack).max() / (2 ** (bits - 1) - 1)
            assert np.abs(got_mean.numpy() - stack.mean(0)).max() <= step * 1.0001


def test_dp_builders_refuse_what_they_cannot_train():
    tr = ptr.CTRTrainer(ptr.TrainerConfig(
        spec=methods.EmbeddingSpec(method="alpt", n=N_FEATURES, d=8), dcn=pctr.DCNConfig(**DCN_KW),
        cache_rows=16), device="cpu")
    with pytest.raises(ValueError, match="hot-row cache"):
        dpm.make_ctr_microbatch_step(tr, 2)
    with pytest.raises(RuntimeError, match="init_process_group"):
        dpm.make_ctr_dp_step(ptr.CTRTrainer(dataclasses.replace(tr.cfg, cache_rows=0),
                                            device="cpu"))
    with pytest.raises(RuntimeError, match="init_process_group"):
        dpm.make_lm_dp_step(configs.smoke_config("smollm-135m"), lm_trainer.LMTrainerConfig())
    uncached = ptr.CTRTrainer(dataclasses.replace(tr.cfg, cache_rows=0), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        dpm.make_ctr_microbatch_step(uncached, 3)(uncached.init_state(),
                                                  *DATA.batch("train", 0, BATCH))
    # remat is taken (its refusal lifted with the remat slice): the twin with
    # it is bitwise the twin without.
    tcfg = lm_trainer.LMTrainerConfig()
    cfg = dataclasses.replace(configs.smoke_config("smollm-135m"), n_layers=1)
    full = torch.from_numpy(LMTokenStream(cfg.vocab_size, 16, seed=17).batch(0, 4))
    batch = {"tokens": full[:, :-1], "labels": full[:, 1:]}
    runs = []
    for remat in (True, False):
        cfg = dataclasses.replace(cfg, remat=remat)
        state, m = dpm.make_lm_microbatch_step(cfg, tcfg, 2, dpm.DPConfig(sync_bits=8))(
            lm_trainer.init_state(cfg, tcfg, seed=1, device="cpu"), batch)
        runs.append([m["loss"], *tree_leaves(state.params), state.table.codes.data])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ------------------------------------------- (f) n ranks over gloo, (g) CLI

RANKS = textwrap.dedent('''
    import dataclasses, datetime, hashlib, json, os, signal, sys
    import torch, torch.distributed as dist
    from repro_torch import configs, methods
    from repro_torch.core.alpt import ALPTConfig
    from repro_torch.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
    from repro_torch.data.lm_synth import LMTokenStream
    from repro_torch.launch.train import lm_batch
    from repro_torch.models.ctr import DCNConfig
    from repro_torch.training import data_parallel as dpm, lm_trainer
    from repro_torch.training.ctr_trainer import CTRTrainer, TrainerConfig

    scenario, rank, world, init = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))

    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if hasattr(x, "data") and hasattr(x, "packed"):
            return [x.data]
        if isinstance(x, torch.nn.Module):
            return list(x.state_dict().values())
        if isinstance(x, torch.Generator):
            return [x.get_state()]
        if isinstance(x, dict):
            return [t for k in sorted(x) for t in leaves(x[k])]
        if isinstance(x, (list, tuple)):
            return [t for v in x for t in leaves(v)]
        if isinstance(x, (int, float)):
            return [torch.tensor(x)]
        return []

    def digest(state):
        h = hashlib.sha256()
        for t in leaves(tuple(state)):
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()

    out = {}
    if scenario == "dp":
        cards = (17, 29, 11, 41, 13, 23)
        data = CTRSynthetic(CTRDatasetConfig(name="mini", n_fields=6, cardinalities=cards,
                                             teacher_rank=4, seed=3))
        for method, bits in (("alpt", 32), ("alpt", 8), ("alpt", 4), ("alpt", 2),
                             ("qr_alpt", 8), ("mixed", 4), ("lpt", 2), ("lsq", 32)):
            spec = methods.EmbeddingSpec(method=method, n=sum(cards), d=8, bits=8,
                                         init_scale=0.05, alpt=ALPTConfig(step_lr=2e-4),
                                         field_cards=cards, field_bits=(8, 4, 8, 2, 8, 4),
                                         pad_to_tiles=method == "alpt")
            cfg = TrainerConfig(spec=spec, dcn=DCNConfig(6, 8, 2, (32, 16), dropout=0.2),
                                lr=1e-3)
            tr = CTRTrainer(cfg, device="cpu")
            dp = dpm.DPConfig(sync_bits=bits)
            step, twin = dpm.make_ctr_dp_step(tr, dp=dp), dpm.make_ctr_microbatch_step(
                tr, world, dp)
            a, b = tr.init_state(), tr.init_state()
            losses = []
            for i in range(2):
                ids, labels = data.batch("train", i, 16 * world)
                a, ma = step(a, ids, labels)
                b, mb = twin(b, ids, labels)
                losses.append([float(ma["loss"]), float(mb["loss"])])
            out[f"ctr/{method}/{bits}"] = [digest(a), digest(b), losses]
        for arch, method, bits in (("smollm-135m", "alpt", 8), ("smollm-135m", "alpt", 32),
                                   ("smollm-135m", "lpt", 4), ("smollm-135m", "fp", 2),
                                   ("hubert-xlarge", "alpt", 8)):
            cfg = dataclasses.replace(configs.smoke_config(arch),
                                      embedding_method=method, n_layers=1)
            tcfg = lm_trainer.LMTrainerConfig(lr=1e-3)
            dp = dpm.DPConfig(sync_bits=bits)
            step, twin = dpm.make_lm_dp_step(cfg, tcfg, dp=dp), dpm.make_lm_microbatch_step(
                cfg, tcfg, world, dp)
            a = lm_trainer.init_state(cfg, tcfg, device="cpu")
            b = lm_trainer.init_state(cfg, tcfg, device="cpu")
            losses = []
            for i in range(2):
                batch = lm_batch(cfg, LMTokenStream(cfg.vocab_size, 16, seed=17), i, 2 * world,
                                 16, torch.device("cpu"))
                a, ma = step(a, batch)
                b, mb = twin(b, batch)
                losses.append([float(ma["loss"]), float(mb["loss"])])
            out[f"lm/{arch}/{method}/{bits}"] = [digest(a), digest(b), losses]
    else:  # "sigterm": one rank is signalled during step 2; both stop there
        from repro_torch.launch import train as train_cli
        os.environ["WORLD_SIZE"] = str(world)
        batch = LMTokenStream.batch

        def batch_then_signal(self, i, size):
            if rank == 1 and i == 1:
                signal.raise_signal(signal.SIGTERM)
            return batch(self, i, size)

        LMTokenStream.batch = batch_then_signal
        out["rc"] = train_cli.main(["lm", "--arch", "smollm-135m", "--smoke", "--device", "cpu",
                                    "--steps", "6", "--batch", "4", "--seq", "16",
                                    "--mesh-data", str(world), "--dp-compress-bits", "8",
                                    "--ckpt-dir", sys.argv[5], "--ckpt-every", "100"])
    print("RESULT " + json.dumps(out), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
''')


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO / "src")}


def _run_ranks(tmp_path, scenario, world, *extra, timeout=240):
    """``world`` processes of :data:`RANKS` -> each rank's RESULT dict."""
    init = tmp_path / f"init-{scenario}-{world}"
    procs = [subprocess.Popen([sys.executable, "-c", RANKS, scenario, str(r), str(world),
                               str(init), *map(str, extra)], cwd=REPO, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            assert p.returncode == 0, stderr[-3000:]
            line = next(x for x in stdout.splitlines() if x.startswith("RESULT "))
            outs.append(json.loads(line[len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_dp_steps_bitwise_their_microbatched_twins(tmp_path, world):
    """``make_ctr_dp_step`` / ``make_lm_dp_step`` on ``world`` processes
    (CTR with dropout 0.2; alpt padded, qr_alpt's two Delta leaves, mixed's
    three groups, lsq's float leaves; the LM on tokens and, hubert-smoke's
    encoder, on frames cut on their batch dimension) against each rank's
    own twin with ``n_shards = world``: every leaf, the generator and the
    losses bitwise; every rank the same state."""
    outs = _run_ranks(tmp_path, "dp", world)
    assert len(outs[0]) == 8 + 5
    for key, (dp_digest, twin_digest, losses) in outs[0].items():
        assert dp_digest == twin_digest, key
        assert all(a == b for a, b in losses), (key, losses)
        for other in outs[1:]:
            assert other[key][0] == dp_digest, key


def test_cli_sigterm_on_one_rank_stops_every_rank_at_the_same_step(tmp_path):
    ck = tmp_path / "ck"
    outs = _run_ranks(tmp_path, "sigterm", 2, ck)
    assert [o["rc"] for o in outs] == [75, 75]
    steps = sorted(p.name for p in ck.iterdir() if p.name.endswith(".COMMITTED"))
    assert steps == ["step_000000002.COMMITTED"]


def test_cli_mesh_data_2_under_torchrun_then_resumed_at_mesh_data_1(tmp_path, capsys):
    """Two ranks under ``torch.distributed.run``: rank 0 alone prints, its
    losses are the microbatched twin's bit for bit, its checkpoint resumes
    in a one-rank run."""
    ck = tmp_path / "ck"
    argv = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--batch", "4", "--seq",
            "16", "--ckpt-dir", str(ck), "--ckpt-every", "1", "--dp-compress-bits", "4"]
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.train", "lm", *argv, "--steps", "2", "--mesh-data", "2"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.splitlines()
    assert sum("wire_bytes/step=" in x for x in lines) == 1  # rank 0 only
    report = json.loads(lines[-1])
    assert report["mesh_data"] == 2 and report["sync_bits"] == 4
    cfg = configs.smoke_config("smollm-135m")
    tcfg = lm_trainer.LMTrainerConfig(lr=3e-4)
    twin = dpm.make_lm_microbatch_step(cfg, tcfg, 2, dpm.DPConfig(sync_bits=4))
    state = lm_trainer.init_state(cfg, tcfg, seed=0, device="cpu")
    want, threads = [], torch.get_num_threads()
    torch.set_num_threads(1)  # as torch.distributed.run's ranks (OMP_NUM_THREADS=1)
    try:
        for i in range(2):
            full = torch.from_numpy(LMTokenStream(cfg.vocab_size, 16, seed=17).batch(i, 4))
            state, m = twin(state, {"tokens": full[:, :-1], "labels": full[:, 1:]})
            want.append(float(m["loss"]))
    finally:
        torch.set_num_threads(threads)
    assert report["losses"] == want
    shapes = dpm.lm_grad_shapes(cfg, tcfg, state)
    assert report["wire_bytes_per_step"] == collectives.sync_wire_bytes(shapes, 4)
    assert f"wire_bytes/step={report['wire_bytes_per_step']} " in run.stdout

    capsys.readouterr()
    assert train_cli.main(["lm", *argv, "--steps", "3", "--mesh-data", "1"]) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out
    resumed = json.loads(out.strip().splitlines()[-1])
    assert resumed["start_step"] == 2 and resumed["mesh_data"] == 1
    assert len(resumed["losses"]) == 1 and np.isfinite(resumed["losses"][0])


@pytest.mark.parametrize("argv,message", [
    (["--mesh-model", "2", "--dp-compress-bits", "8"], "pure data parallelism"),
    (["--mesh-model", "2"], "takes 2 processes"),
    (["--mesh-data", "2"], "takes 2 processes"),
    (["--dp-compress-bits", "16"], "must be 32"),
    (["--dp-compress-bits", "1"], "must be 32"),
    (["--mesh-data", "2", "--dp-compress-bits", "8"], "torch.distributed.run"),
    (["--mesh-data", "0", "--dp-compress-bits", "8"], ">= 1"),
    (["--mesh-data", "3", "--dp-compress-bits", "8", "--batch", "8"], "multiple"),
])
def test_cli_refuses_what_the_reference_refuses(argv, message, capsys, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if message == "multiple":
        monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["lm", "--smoke", "--device", "cpu", *argv])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_cli_mesh_data_must_equal_world_size(capsys, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit):
        train_cli.main(["lm", "--smoke", "--device", "cpu", "--mesh-data", "2",
                        "--dp-compress-bits", "8"])
    assert "WORLD_SIZE 4" in capsys.readouterr().err
