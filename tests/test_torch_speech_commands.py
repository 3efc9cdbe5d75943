"""The port's Speech Commands loader against the JAX package's on the same
seeded wav trees: every array of the split bit for bit, the decode cache,
and the errors."""

import json
import warnings
import wave

import numpy as np
import pytest
import torch

from tcresnet_tpu import const
from tcresnet_tpu.data import speech_commands as jsc
from tcresnet_tpu.data import wav as jwav
from tcresnet_tpu_torch.data import native_loader
from tcresnet_tpu_torch.data import speech_commands as tsc
from tcresnet_tpu_torch.data.device_data import DeviceDataset

N = 1600  # samples a clip


def _tree(root, rng, labels, counts, speakers="abcdefgh"):
    """<root>/train/<label>/*.wav tones per label (some short, some long,
    some silent-quiet) and a noise dir with one long clip and one too short
    to crop."""
    for li, label in enumerate(labels):
        for i in range(counts[li]):
            n = (N, N // 2, N + 700)[i % 3]
            t = np.arange(n) / 16000
            sig = 0.4 * np.sin(2 * np.pi * (300 + 150 * li) * t + i) + rng.normal(0, 0.02, n)
            jwav.write_wav_pcm16(root / "train" / label / f"{speakers[i % 8]}{i}_nohash_0.wav",
                                 sig)
    noise = root / "train" / const.BACKGROUND_NOISE_DIR_NAME
    jwav.write_wav_pcm16(noise / "long.wav", rng.uniform(-0.3, 0.3, 5 * N + 123))
    jwav.write_wav_pcm16(noise / "mid.wav", rng.uniform(-0.3, 0.3, 2 * N))
    jwav.write_wav_pcm16(noise / "tiny.wav", rng.uniform(-0.3, 0.3, N // 4))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("gsc")
    rng = np.random.default_rng(0)
    _tree(base / "a", rng, ["yes", "no", "unknown"], [5, 3, 7])
    _tree(base / "b", rng, ["yes", "no", "unknown"], [2, 4, 1])
    return base / "a", base / "b"


def _assert_same(got, want):
    np.testing.assert_array_equal(got.wavs, want.wavs)
    assert got.wavs.dtype == want.wavs.dtype == np.int16
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == want.labels.dtype == np.int32
    np.testing.assert_array_equal(got.is_silent, want.is_silent)
    assert got.label_names == want.label_names
    assert (got.noise_bank is None) == (want.noise_bank is None)
    if want.noise_bank is not None:
        np.testing.assert_array_equal(got.noise_bank, want.noise_bank)
        assert got.noise_bank.dtype == np.float32
    assert (got.sample_row is None) == (want.sample_row is None)
    if want.sample_row is not None:
        np.testing.assert_array_equal(got.sample_row, want.sample_row)
        assert got.sample_row.dtype == np.int32
    assert (got.split, got.num_samples, got.num_logical_samples, got.num_classes) == (
        want.split, want.num_samples, want.num_logical_samples, want.num_classes)


@pytest.mark.parametrize("two_roots", [False, True], ids=["one_root", "two_roots"])
@pytest.mark.parametrize("oversampling", [None, 0.5], ids=["plain", "oversampled"])
@pytest.mark.parametrize("num_silent", [-1, 0, 3])
def test_host_dataset_bit_equal_to_jax(roots, two_roots, oversampling, num_silent):
    root = list(roots) if two_roots else str(roots[0])
    kw = dict(desired_samples=N, num_silent=num_silent, oversampling_ratio=oversampling,
              sample_rate=16000)
    want = jsc.load_speech_commands(root, "train", **kw)
    got = tsc.load_speech_commands(root, "train", **kw)
    _assert_same(got, want)
    assert got.noise_bank.shape == ((4 if two_roots else 2), 5 * N + 123)


def test_pieces_equal_jax(roots):
    split = roots[0] / "train"
    assert tsc.discover_labels(split) == jsc.discover_labels(split)
    assert tsc.discover_labels(split, False) == jsc.discover_labels(split, False)
    labels = jsc.discover_labels(split)
    assert tsc.list_files(split, labels) == jsc.list_files(split, labels)
    files = [f"f{i}" for i in range(40)]
    lab = [0] * 30 + [1] * 7 + [2] * 3
    for ratio in (0.1, 0.5, 1.0):
        assert tsc.oversample(files, lab, ratio) == jsc.oversample(files, lab, ratio)
    np.testing.assert_array_equal(tsc.load_noise_bank([split, roots[1] / "train"], N),
                                  jsc.load_noise_bank([split, roots[1] / "train"], N))
    assert tsc.load_noise_bank(split, 10**7) is None
    f, _ = jsc.list_files(split, labels)
    assert tsc._cache_key(f, N) == jsc._cache_key(f, N)


def test_labels_must_agree_across_roots(tmp_path, roots):
    rng = np.random.default_rng(1)
    _tree(tmp_path / "c", rng, ["yes", "maybe"], [2, 2])
    for load in (tsc.load_speech_commands, jsc.load_speech_commands):
        with pytest.raises(ValueError, match="Different labels"):
            load([roots[0], tmp_path / "c"], "train", N, 0)
    with pytest.raises(FileNotFoundError):
        tsc.load_speech_commands(tmp_path / "none", "train", N)


def test_decode_cache_hit_equals_the_decode_and_writes_atomically(tmp_path, roots, monkeypatch):
    cache = tmp_path / "cache"
    first = tsc.load_speech_commands(str(roots[0]), "train", N, num_silent=0, cache_dir=cache)
    files = sorted(p.name for p in cache.iterdir())
    assert len(files) == 1 and files[0].startswith("train-") and files[0].endswith(".npy")
    decoded = native_loader.files_decoded
    hit = tsc.load_speech_commands(str(roots[0]), "train", N, num_silent=0, cache_dir=cache)
    assert native_loader.files_decoded == decoded  # nothing decoded on a hit
    assert not hit.wavs.flags.writeable  # the cache's read-only memory map
    _assert_same(hit, first)
    _assert_same(hit, jsc.load_speech_commands(str(roots[0]), "train", N, num_silent=0))
    # the device split owns a copy of a read-only map, with no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ds = DeviceDataset(hit, "cpu")
    assert torch.equal(ds.wavs, torch.from_numpy(np.array(hit.wavs)))
    assert ds.wavs.data_ptr() != hit.wavs.ctypes.data

    # a save cut off half-way leaves nothing at the keyed path
    other = tmp_path / "cut"

    def cut(path, arr):
        with open(path, "wb") as fh:
            fh.write(b"\x93NUMPY partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(tsc.np, "save", cut)
    with pytest.raises(KeyboardInterrupt):
        tsc.load_speech_commands(str(roots[0]), "train", N, num_silent=0, cache_dir=other)
    monkeypatch.undo()
    assert [p.name for p in other.iterdir()] == [files[0] + ".tmp.npy"]
    again = tsc.load_speech_commands(str(roots[0]), "train", N, num_silent=0, cache_dir=other)
    _assert_same(again, first)
    assert sorted(p.name for p in other.iterdir()) == [files[0]]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_wrong_rate_and_malformed_wavs_raise(tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setattr(native_loader, "decode_batch", lambda *a, **k: None)
    rng = np.random.default_rng(2)
    jwav.write_wav_pcm16(tmp_path / "r" / "train" / "yes" / "a.wav", rng.uniform(-0.5, 0.5, N))
    jwav.write_wav_pcm16(tmp_path / "r" / "train" / "no" / "b.wav", rng.uniform(-0.5, 0.5, N),
                         sample_rate=8000)
    with pytest.raises(ValueError):
        tsc.load_speech_commands(tmp_path / "r", "train", N, sample_rate=16000)
    assert tsc.load_speech_commands(tmp_path / "r", "train", N, num_silent=0).num_samples == 2
    (tmp_path / "m" / "train" / "yes").mkdir(parents=True)
    (tmp_path / "m" / "train" / "yes" / "bad.wav").write_bytes(b"RIFF\x00\x00\x00\x00WAVE")
    # the native decoder's ValueError, or the wave module's error (as in JAX)
    with pytest.raises((ValueError, EOFError, wave.Error)):
        tsc.load_speech_commands(tmp_path / "m", "train", N)


def test_prepare_train_warm_start_and_evaluate_clis_on_a_tree(tmp_path):
    """The whole path on the CPU: prepare_dataset --extracted, train from
    --dataset-root scored on --eval-split test, evaluate --split test of
    the promoted best, a warm start with fc excluded and only fc trained,
    and its resume under the relative LR shift."""
    from tcresnet_tpu_torch.tools import evaluate as evaluate_cli
    from tcresnet_tpu_torch.tools import prepare_dataset as prep
    from tcresnet_tpu_torch.tools import train as train_cli

    n, rng = 3200, np.random.default_rng(5)
    raw, per_split = tmp_path / "raw", {}
    for wi, word in enumerate(("yes", "no", "cat")):
        i = 0
        while min(per_split.get((word, s), 0) for s in ("train", "valid", "test")) < 3:
            name = f"{int(rng.integers(0, 2**32)):08x}_nohash_0.wav"
            split = prep.which_set(name, 30, 30)
            per_split[(word, split)] = per_split.get((word, split), 0) + 1
            jwav.write_wav_pcm16(raw / word / name, 0.4 * np.sin(
                2 * np.pi * (300 + 200 * wi) * np.arange(n) / 16000 + i))
            i += 1
    jwav.write_wav_pcm16(raw / const.BACKGROUND_NOISE_DIR_NAME / "n.wav",
                         rng.uniform(-0.3, 0.3, 3 * n))
    tree = tmp_path / "tree"
    prep.main(["--extracted", str(raw), "--out", str(tree), "--wanted-words", "yes,no",
               "--validation-pct", "30", "--testing-pct", "30", "--unknown-pct", "100"])

    common = ["--dataset-root", str(tree), "--cache-dir", str(tmp_path / "cache"),
              "--device", "cpu", "--batch-size", "8", "--clip-duration-ms", "200",
              "--cfg", "model.num_classes=4", "--cfg", "audio.num_mfccs=20",
              "--cfg", "audio.num_mel_bins=32", "--cfg", "optim.lr_list=[0.1,0.01]",
              "--cfg", "optim.boundaries=[1]"]
    run = tmp_path / "run"
    trainer = train_cli.main(common + ["--train-dir", str(run), "--max-step", "2",
                                       "--step-save-checkpoint", "1", "--eval-split", "test",
                                       "--cfg", "data.oversampling_ratio=0.5"])
    assert int(trainer.state.step) == 2 and trainer.data.num_logical_samples > \
        trainer.data.num_samples
    scored = [json.loads(x) for x in (run / "test_metrics.jsonl").read_text().splitlines()]
    test_rows = sum(per_split[(w, "test")] for w in ("yes", "no", "cat"))
    assert scored[-1]["step"] == 2 and scored[-1]["num_samples"] == test_rows + test_rows // 4
    assert (tmp_path / "cache").is_dir() and len(list((tmp_path / "cache").iterdir())) == 2
    again = evaluate_cli.main(["--train-dir", str(run), "--split", "test", "--device", "cpu",
                               "--best-metric", "accuracy", "--best-split", "test"])
    for key in ("accuracy", "loss"):
        assert again[key] == scored[-1][key]

    fine = tmp_path / "fine"
    warm = train_cli.main(common + [
        "--train-dir", str(fine), "--max-step", "2", "--eval-split", "",
        "--checkpoint-path", str(run / "ckpt"), "--checkpoint-exclude-scopes", "fc",
        "--cfg", 'optim.trainable_scopes=["fc"]'])
    src = trainer.state.params
    for k, v in warm.state.params.items():
        assert torch.equal(v, src[k]) != k.startswith("fc."), k
    resumed = train_cli.main(common + [
        "--train-dir", str(fine), "--max-step", "3", "--eval-split", "",
        "--checkpoint-path", str(run / "ckpt"), "--checkpoint-exclude-scopes", "fc",
        "--cfg", 'optim.trainable_scopes=["fc"]', "--cfg", "optim.relative_schedule=true"])
    assert int(resumed.state.step) == 3
    assert resumed.lr_schedule(2) == 0.1 and warm.lr_schedule(2) == 0.01


def test_train_dir_expansion_and_roots_equal_jax(tmp_path):
    """expand_train_dir against the JAX CLI's, and several roots kept in
    the config (a tuple through config.json)."""
    from tcresnet_tpu_torch.config import ExperimentConfig
    from tcresnet_tpu_torch.tools import train as train_cli
    from tests.test_torch_config import to_jax_config
    from tools import train as jtrain_cli

    args = train_cli.parse_args(["--dataset-root", "a", "b", "--batch-size", "64",
                                 "--cfg", "optim.lr_list=[0.1,0.01]"])
    cfg = train_cli.build_config(args)
    assert cfg.data.dataset_root == ("a", "b")
    assert ExperimentConfig.from_json(cfg.to_json()) == cfg
    one = train_cli.build_config(train_cli.parse_args(["--dataset-root", str(tmp_path)]))
    assert one.data.dataset_root == str(tmp_path)
    template = "runs/%USER%_%BATCH_SIZE%_%LR_LIST%_%DATASET_ROOT%_%NAME%_%NO_SUCH%"
    for c in (cfg, one):
        assert train_cli.expand_train_dir(template, c) == jtrain_cli.expand_train_dir(
            template, to_jax_config(c))
    assert "%" not in train_cli.expand_train_dir("runs/%DATE%")
