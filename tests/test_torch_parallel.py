"""Data parallelism of the port (tcresnet_tpu_torch/parallel/mesh.py) on
gloo CPU ranks, against the JAX package's mesh, its full-batch step and
the port's own 1-process run.

Each multi-rank case spawns its ranks through `mesh.launch` (a file-store
rendezvous in a temporary directory, so that test workers cannot collide)
and joins them with a timeout of its own; the rank functions live in
tests/test_torch_dp_ranks.py, which imports no JAX.
"""

import contextlib
import dataclasses
import json
import signal

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu.config import MeshConfig as JaxMeshConfig
from tcresnet_tpu.parallel import make_mesh as jax_make_mesh
from tcresnet_tpu_torch.config import AudioConfig, AugmentConfig, ExperimentConfig
from tcresnet_tpu_torch.config import MeshConfig, ModelConfig, OptimConfig, TrainConfig
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
from tcresnet_tpu_torch.models import layers
from tcresnet_tpu_torch.models.convert import variables_to_jax
from tcresnet_tpu_torch.ops import augment as aug
from tcresnet_tpu_torch.ops.kernels.augment import AugmentScalars
from tcresnet_tpu_torch.parallel import mesh as meshlib
from tcresnet_tpu_torch.train.trainer import Trainer
from tests import test_torch_dp_ranks as ranks
from tests.test_torch_train import BATCH, N, jax_step_losses, step_draws

torch.set_num_threads(1)

JOIN_S = 120  # each launch's own timeout
CPU = torch.device("cpu")


def launch(fn, *args, n=2, model=1):
    return meshlib.launch(fn, *args, cfg=MeshConfig(data=n // model, model=model),
                          devices=[CPU] * n, timeout=JOIN_S)


@contextlib.contextmanager
def deadline(seconds=JOIN_S):
    """Raise TimeoutError in this (main) thread after `seconds`: the bound of
    a launch made without a timeout of its own (a CLI's); the launcher
    kills its ranks on the way out."""
    def expire(signum, frame):
        raise TimeoutError(f"no result within {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


# ---------------------------------------------------------------------------
# the mesh, against JAX's make_mesh on the 8 virtual CPU devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data,model", [(-1, 1), (-1, 2), (-1, 3), (16, 1), (2, 3), (4, 2)])
def test_make_mesh_shapes_and_messages_match_jax(cpu_devices, data, model):
    """The cases of tests/test_parallel.py: the default mesh, a model axis,
    a model axis that does not divide, too few devices, and explicit axes
    that truncate, each accepted or refused as JAX does, same message."""
    try:
        want = dict(jax_make_mesh(JaxMeshConfig(data=data, model=model),
                                  devices=cpu_devices).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            meshlib.make_mesh(MeshConfig(data=data, model=model), devices=[CPU] * 8)
        assert str(got.value) == str(e)
        return
    mesh = meshlib.make_mesh(MeshConfig(data=data, model=model), devices=[CPU] * 8)
    assert mesh.shape == want
    assert len(mesh.devices) == mesh.world_size == want["data"] * want["model"]
    assert mesh.rank == 0 and mesh.data_group is None


@pytest.mark.parametrize("data,batch", [(2, 8), (4, 8), (8, 16), (2, 9), (3, 8), (4, 6)])
def test_batch_rows_are_xlas_layout(cpu_devices, data, batch):
    """Each data index keeps one block of ceil(B / data) rows, in order:
    JAX's own shards where the batch divides; every row once, the last
    blocks short or empty, where it does not (XLA pads such a dimension)."""
    blocks = [meshlib.batch_rows(meshlib.Mesh(data, 1, r, (CPU,) * data), batch)
              for r in range(data)]
    assert [i for b in blocks for i in range(b.start, b.stop)] == list(range(batch))
    assert all(b.stop - b.start in (0, -(-batch // data)) for b in blocks[:-1])
    if batch % data == 0:
        jmesh = jax_make_mesh(JaxMeshConfig(data=data), devices=cpu_devices)
        sharding = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec("data"))
        want = sharding.devices_indices_map((batch,))
        assert blocks == [want[d][0] for d in jmesh.devices[:, 0]]
    assert meshlib.batch_rows(None, batch) == slice(0, batch)


def test_a_sharded_generator_keeps_its_rows_of_the_global_draws():
    """Indices, augmentation scalars and the dropout mask drawn through a
    ShardedGenerator that keeps rows [3, 7) of 10 are those rows of one
    process's draws, and leave the generator where that process's would."""
    host = make_synthetic_dataset(num_samples=30, num_classes=4, desired_samples=800, seed=2)
    arrays = DeviceDataset(host, "cpu").arrays
    noise = torch.tensor(host.noise_bank)
    cfg = AugmentConfig(background_frequency=0.5, background_max_volume=0.2,
                        naive_background_mix=False)

    def draws(gen, n):
        idx, _, silent = DeviceDataset.sample_indices(arrays, gen, n)
        scalars = aug.draw_scalars(gen, silent, cfg, noise, 800, True)
        mask = layers.dropout(torch.ones(n, 5), 0.5, True, gen)
        return [idx, *scalars[:4], mask, torch.rand(3, generator=gen)]

    whole = draws(torch.Generator().manual_seed(7), 10)
    part = draws(meshlib.ShardedGenerator().manual_seed(7).keep(slice(3, 7), 10), 4)
    for w, p in zip(whole[:-1], part[:-1]):
        assert torch.equal(w[3:7], p)
    assert torch.equal(whole[-1], part[-1])
    with pytest.raises(ValueError, match="a draw of 5 rows"):
        DeviceDataset.sample_indices(
            arrays, meshlib.ShardedGenerator().keep(slice(3, 7), 10), 5)


# ---------------------------------------------------------------------------
# BatchNorm over ranks against Flax on the full batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_batch_norm_over_ranks_matches_flax_on_the_full_batch(n):
    """Outputs, running statistics and the gradients of input, scale and
    shift within 1e-6 of Flax's BatchNorm over the whole batch (of max|x|
    where that exceeds 1: the dead channel's input gradient reaches ~30,
    1 / sqrt(epsilon)), with a dead channel (all zeros: jnp.maximum's tie
    in the variance); the statistics and parameter gradients bit-equal on
    every rank."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 5, 7)).astype(np.float32) * 2 + 0.5
    x[:, 2] = 0.0
    weights = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    shift = rng.standard_normal(5).astype(np.float32)
    got = launch(ranks.batch_norm_rank, x, weights, scale, shift, n=n)

    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3)
    xj = jnp.asarray(x.transpose(0, 2, 1))  # Flax normalises the last axis
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(shift)},
                 "batch_stats": {"mean": jnp.zeros(5), "var": jnp.ones(5)}}

    def loss(params, xj):
        y, mutated = bn.apply({**variables, "params": params}, xj, mutable=["batch_stats"])
        return jnp.sum(y * weights.transpose(0, 2, 1)), (y, mutated["batch_stats"])

    (_, (y, stats)), (dparams, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], xj)
    def close(a, want):
        want = np.asarray(want)
        np.testing.assert_allclose(a, want, rtol=0,
                                   atol=1e-6 * max(1.0, float(np.abs(want).max())))

    close(np.concatenate([r["y"] for r in got]), np.asarray(y).transpose(0, 2, 1))
    close(np.concatenate([r["dx"] for r in got]), np.asarray(dx).transpose(0, 2, 1))
    for r in got:
        close(r["mean"], stats["mean"])
        close(r["var"], stats["var"])
        close(r["dscale"], dparams["scale"])
        close(r["dshift"], dparams["bias"])
        for key in ("mean", "var", "dscale", "dshift"):
            np.testing.assert_array_equal(r[key], got[0][key])


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------


def _step_cfg(tmp_path, fuse, conv_backend, batch=BATCH):
    return ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=200, num_mel_bins=32, num_mfccs=20,
                          dsp_backend="pallas", frontend_fuse=fuse),
        augment=AugmentConfig(background_frequency=0.8, background_max_volume=0.3,
                              backend="pallas"),
        model=ModelConfig(name="TCResNet8", num_classes=4, dropout_keep_prob=1.0,
                          label_smoothing=0.1, conv_backend=conv_backend),
        optim=OptimConfig(optimizer="mom", lr_list=(0.1, 0.05), boundaries=(1,)),
        train=TrainConfig(batch_size=batch, train_dir=str(tmp_path)),
    )


def _one_process_injected(monkeypatch, cfg, host, draws, workdir):
    """The port's 1-process Trainer with the same injected draws."""
    calls = {"n": 0}

    def fake_indices(arrays, generator, batch_size, sample_row=None):
        idx = torch.tensor(draws[calls["n"]]["idx"])
        return idx, arrays[1][idx.long()], arrays[2][idx.long()]

    def fake_scalars(generator, is_silent, aug_cfg, noise_bank, n, is_training):
        d = draws[calls["n"]]
        calls["n"] += 1
        keeps = torch.where(is_silent, 0.0, 1.0).to(torch.float32)
        return AugmentScalars(*(torch.tensor(a) for a in d["scalars"]), keeps)

    monkeypatch.setattr(DeviceDataset, "sample_indices", staticmethod(fake_indices))
    monkeypatch.setattr(aug, "draw_scalars", fake_scalars)
    trainer = Trainer(cfg, DeviceDataset(host, "cpu"), workdir=workdir)
    init = variables_to_jax(cfg.model, {"params": trainer.state.params,
                                        "batch_stats": trainer.state.batch_stats})
    losses = [float(trainer.train_steps(1)["total_loss"]) for _ in draws]
    return losses, ranks.host_state(trainer.state), init


def _assert_replicated(states):
    """Every rank's params, BN statistics and optimizer state bit-equal."""
    for s in states[1:]:
        for field in s:
            for k in s[field]:
                np.testing.assert_array_equal(s[field][k], states[0][field][k],
                                              err_msg=f"{field} {k}")


def _assert_close(a, b, rel):
    """Each tensor of two states within rel * max|x|."""
    for field in ("params", "batch_stats"):
        for k in a[field]:
            scale = max(float(np.abs(a[field][k]).max()), 1e-30)
            np.testing.assert_allclose(b[field][k], a[field][k], rtol=0, atol=rel * scale,
                                       err_msg=f"{field} {k}")


@pytest.mark.parametrize("n,fuse,conv_backend,batch", [
    pytest.param(2, "off", "pallas", BATCH, id="2-ranks-K1-K2-K7"),
    pytest.param(4, "on", "xla", 6, id="4-ranks-K3-uneven"),
])
def test_dp_steps_match_a_jax_step(tmp_path, monkeypatch, n, fuse, conv_backend, batch):
    """Three steps of the tests/test_torch_train.py harness (injected
    draws, dropout off) on n gloo ranks: losses within 1e-5 of the JAX
    full-batch step (its convs XLA's: the K7 conv against JAX's Pallas conv
    is tests/test_torch_train.py's), params and BN statistics within 1e-5
    (of max|x|) of
    the port's 1-process run, and bit-equal on every rank. Batch 6 over 4
    ranks is 2 + 2 + 2 + 0 rows: JAX takes a batch that does not divide,
    and a rank with no rows still joins every collective."""
    cfg = _step_cfg(tmp_path, fuse, conv_backend, batch)
    host = make_synthetic_dataset(num_samples=40, num_classes=4, desired_samples=N, seed=6)
    draws = step_draws(3, batch)
    got = launch(ranks.injected_steps_rank, cfg, host, draws, str(tmp_path / "dp"), n=n)
    one_losses, one_state, init = _one_process_injected(monkeypatch, cfg, host, draws,
                                                        tmp_path / "one")
    want = jax_step_losses(cfg, host, draws, init, conv_backend="xla")
    for losses, _ in got:
        np.testing.assert_allclose(losses, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(one_losses, want, rtol=0, atol=1e-5)
    _assert_replicated([s for _, s in got])
    _assert_close(one_state, got[0][1], 1e-5)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """8 Adam steps of the JAX package's DP-against-one-device test
    (tests/test_parallel.py, 128 rows, batch 32; dropout 0.5) with EMA and
    checkpoints every 2 steps: 1 process, data=2, and data=2 x model=2."""
    base = tmp_path_factory.mktemp("fits")
    host = make_synthetic_dataset(num_samples=128, num_classes=4, desired_samples=4000, seed=3)
    cfg = ranks.small_cfg(base)
    one = ranks.fit_rank(None, cfg, host, str(base / "one"))
    two = launch(ranks.fit_rank, cfg, host, str(base / "two"))
    model2 = launch(ranks.fit_rank, cfg, host, str(base / "model2"), n=4, model=2)
    return dict(base=base, one=one, two=two, model2=model2, host=host, cfg=cfg)


def test_adam_steps_on_two_ranks_match_one_process(fits):
    """8 Adam steps with the generator's own draws on 2 ranks within 1e-3
    of one process (the JAX package's bound for 8-way DP,
    tests/test_parallel.py: Adam's early steps amplify a summation order's
    rounding), the state bit-equal on both ranks, the
    train-stream eval and the logged losses equal within 1e-5, and one
    writer: each summary step logged once, the checkpoints rank 0 saved."""
    one_state, one_stream = fits["one"]
    _assert_replicated([s for s, _ in fits["two"]])
    for k, want in one_state["params"].items():
        np.testing.assert_allclose(fits["two"][0][0]["params"][k], want, rtol=0, atol=1e-3)
    for _, stream in fits["two"]:
        for k, v in one_stream.items():
            assert stream[k] == pytest.approx(v, abs=1e-5), k

    def logged(run):
        lines = (fits["base"] / run / "train_metrics.jsonl").read_text().splitlines()
        return [json.loads(x) for x in lines if "total_loss" in x]

    one, two = logged("one"), logged("two")
    assert [r["step"] for r in two] == [r["step"] for r in one] == [2, 4, 6, 8]
    for a, b in zip(one, two):
        for k in ("total_loss", "model_loss", "accuracy", "learning_rate"):
            assert b[k] == pytest.approx(a[k], abs=1e-5), k
    ckpts = sorted(p.name for p in (fits["base"] / "two" / "ckpt").iterdir())
    assert ckpts == ["TRAIN_DONE", "ckpt_2.pt", "ckpt_4.pt", "ckpt_6.pt", "ckpt_8.pt"]


def test_the_model_axis_trains_as_model_1(fits):
    """{data 2, model 2}: the model axis replicates, so all four ranks end
    bit-equal to the {data 2} run's ranks."""
    _assert_replicated([s for s, _ in fits["two"]] + [s for s, _ in fits["model2"]])


def test_a_resumed_two_rank_run_equals_an_uninterrupted_one(tmp_path):
    """2 ranks: steps 1-4 straight, and steps 1-2, a checkpoint, a new
    Trainer on each rank restoring it for steps 3-4: the same state."""
    host = make_synthetic_dataset(num_samples=64, num_classes=4, desired_samples=4000, seed=4)
    cfg = ranks.small_cfg(tmp_path, batch_size=8)
    got = launch(ranks.resume_rank, cfg, host, str(tmp_path / "a"), str(tmp_path / "b"))
    _assert_replicated([s for pair in got for s in pair])


def test_frozen_params_stay_put_on_two_ranks(tmp_path):
    """optim.trainable_scopes=("fc",) on 2 ranks: fc's gradient is summed
    and fc moves as in one process (1e-5), every other param stays
    bit-equal to its initial value on both ranks."""
    host = make_synthetic_dataset(num_samples=64, num_classes=4, desired_samples=4000, seed=4)
    cfg = ranks.small_cfg(tmp_path, batch_size=8, max_step=2)
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, trainable_scopes=("fc",)))
    init = ranks.host_state(Trainer(cfg, DeviceDataset(host, "cpu"), workdir=tmp_path / "init")
                            .state)
    one = ranks.fit_rank(None, cfg, host, str(tmp_path / "one"))[0]
    got = launch(ranks.fit_rank, cfg, host, str(tmp_path / "two"))
    _assert_replicated([s for s, _ in got])
    for k, v in got[0][0]["params"].items():
        if k.startswith("fc"):
            assert not np.array_equal(v, init["params"][k])
            np.testing.assert_allclose(v, one["params"][k], rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(v, init["params"][k], err_msg=k)


def test_the_sharded_evaluator_scores_as_one_rank(fits):
    """The 8-step state scored on 2 ranks (eval batch 15: 8 + 7 rows a
    batch, the last one padded; the v2 mix draws each batch's silence
    volumes) equals the 1-rank scores: accuracy exactly, the rest within
    1e-6."""
    state, _ = fits["one"]
    variables = {"params": state["params"], "batch_stats": state["batch_stats"]}
    host = make_synthetic_dataset(num_samples=50, num_classes=4, desired_samples=4000,
                                  seed=1, split="valid")
    cfg = fits["cfg"]
    cfg = cfg.replace(augment=dataclasses.replace(cfg.augment, naive_background_mix=False))
    got = launch(ranks.evaluate_rank, cfg, host, variables)
    want = ranks.evaluate_rank(None, cfg, host, variables)
    for scores in got:
        assert scores["accuracy"] == want["accuracy"]
        assert scores["num_samples"] == want["num_samples"] == 50
        for k, v in want.items():
            if k not in ("batch_infer_time", "unit_infer_time"):
                assert scores[k] == pytest.approx(v, abs=1e-6), k


def test_the_loop_evaluator_outlasts_the_collective_timeout(tmp_path):
    """A checkpoint that comes later than a collective may wait (6 s
    against 3 s): rank 0 tells the ranks once a poll that nothing is new,
    so none waits past the timeout, and both score step 1."""
    cfg = ranks.small_cfg(tmp_path)
    host = make_synthetic_dataset(num_samples=16, num_classes=4, desired_samples=4000,
                                  seed=1, split="valid")
    got = meshlib.launch(ranks.slow_checkpoint_rank, cfg, host, str(tmp_path), 6.0,
                         cfg=MeshConfig(data=2), devices=[CPU] * 2, timeout=JOIN_S,
                         collective_timeout=3.0)
    assert got[0] is not None and got[0]["accuracy"] == got[1]["accuracy"]
    valid = [json.loads(x)["step"]
             for x in (tmp_path / "valid_metrics.jsonl").read_text().splitlines()]
    assert valid == [1]


# ---------------------------------------------------------------------------
# processes and the CLI
# ---------------------------------------------------------------------------


def test_a_failing_rank_fails_the_launch_with_its_traceback():
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 failed.*rank 1 gives up"):
        launch(ranks.failing_rank)


def test_launch_refuses_a_mesh_larger_than_its_devices():
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        meshlib.launch(ranks.rank_rows, 8, cfg=MeshConfig(data=4), devices=[CPU] * 2)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """tools.train --device cpu --synthetic --cfg mesh.data=2: (its ranks'
    results, the run's directory)."""
    from tcresnet_tpu_torch.tools import train as train_cli

    run = tmp_path_factory.mktemp("cli") / "run"
    with deadline():
        got = train_cli.main([
            "--synthetic", "--synthetic-samples", "64", "--clip-duration-ms", "250",
            "--batch-size", "8", "--max-step", "4", "--step-save-checkpoint", "2",
            "--device", "cpu", "--train-dir", str(run), "--cfg", "mesh.data=2"])
    return got, run


def test_train_cli_on_two_cpu_ranks_writes_once(cli_run):
    """The CLI trains to its end on two ranks and scores the valid split;
    rank 0 alone writes: config.json, each summary once, the checkpoints,
    the promoted best."""
    got, run = cli_run
    assert [r["step"] for r in got] == [4, 4]
    assert got[0]["scores"]["accuracy"] == got[1]["scores"]["accuracy"]
    assert json.loads((run / "config.json").read_text())["mesh"]["data"] == 2
    steps = [json.loads(x)["step"] for x in (run / "train_metrics.jsonl").read_text().splitlines()
             if "total_loss" in x]
    assert steps == sorted(set(steps)) and steps[-1] == 4
    valid = (run / "valid_metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in valid] == [4]
    assert sorted(p.name for p in (run / "ckpt").iterdir()) == [
        "TRAIN_DONE", "ckpt_2.pt", "ckpt_4.pt"]
    assert (run / "best" / "valid" / "accuracy").is_dir()
    assert not list(run.rglob("*.tmp*"))


def test_evaluate_cli_loop_on_the_runs_two_ranks(cli_run):
    """tools.evaluate --valid-type loop over that run takes the run's
    mesh.data=2: rank 0's listing of the checkpoints is broadcast, both
    ranks score steps 2 and 4, and each is written once; the score of
    step 4 equals the train CLI's."""
    from tcresnet_tpu_torch.tools import evaluate as evaluate_cli

    got, run = cli_run
    with deadline():
        scores = evaluate_cli.main(["--train-dir", str(run), "--synthetic", "--device", "cpu",
                                    "--valid-type", "loop", "--timeout", "0"])
    assert scores["accuracy"] == got[0]["scores"]["accuracy"]
    valid = [json.loads(x)["step"] for x in (run / "valid_metrics.jsonl").read_text().splitlines()]
    assert valid == [4, 2, 4]


def test_profile_dir_writes_a_trace(tmp_path):
    """tools.train --profile-dir leaves a torch.profiler Chrome trace with
    the step's operators in it."""
    from tcresnet_tpu_torch.tools import train as train_cli

    train_cli.main([
        "--synthetic", "--synthetic-samples", "32", "--clip-duration-ms", "250",
        "--batch-size", "4", "--max-step", "2", "--eval-split", "", "--device", "cpu",
        "--train-dir", str(tmp_path / "run"), "--profile-dir", str(tmp_path / "prof")])
    traces = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
