"""The port's prepare_dataset against the JAX package's tool: the same
files in the same splits, in every mode."""

import tarfile

import numpy as np
import pytest

from tcresnet_tpu.data import wav as jwav
from tcresnet_tpu_torch.tools import prepare_dataset as tprep
from tools import prepare_dataset as jprep


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A GSC-like source: keywords, other words, speaker-hashed names."""
    src = tmp_path_factory.mktemp("raw") / "speech_commands"
    rng = np.random.default_rng(0)
    for word in ["yes", "no", "up", "cat", "bed", "dog"]:
        for i in range(24):
            speaker = f"{int(rng.integers(0, 2**32)):08x}"
            jwav.write_wav_pcm16(src / word / f"{speaker}_nohash_{i % 3}.wav",
                                 rng.uniform(-0.5, 0.5, 200))
    jwav.write_wav_pcm16(src / "_background_noise_" / "n.wav", rng.uniform(-0.3, 0.3, 800))
    return src


def _lists(raw, tmp_path, layout):
    lists = tmp_path / "lists"
    lists.mkdir()
    names = sorted(p.relative_to(raw).as_posix() for p in raw.glob("*/*.wav")
                   if p.parent.name != "_background_noise_")
    if layout == "output":  # already unknown/<word>_<file> for the other words
        names = [n if n.split("/")[0] in ("yes", "no", "up") else
                 "unknown/" + n.replace("/", "_", 1) for n in names]
    (lists / "train.txt").write_text("\n".join(names[::2]) + "\n_silence_/x_nohash_0.wav\n")
    (lists / "valid.txt").write_text("\n".join(names[1::4]) + "\n")
    (lists / "test.txt").write_text("\n".join(names[3::4]) + "\n")
    return ["--split-lists", str(lists)]


def _placed(out):
    """The split trees' files (an archive also unpacks under _extracted/)."""
    return sorted(p.relative_to(out).as_posix() for p in out.glob("*/*/*.wav")
                  if p.relative_to(out).parts[0] in ("train", "valid", "test"))


@pytest.mark.parametrize("mode", ["extracted", "archive", "lists_source", "lists_output",
                                  "wanted_words"])
def test_same_files_per_split_as_jax(raw, tmp_path, capsys, mode):
    src = ["--extracted", str(raw)]
    extra = ["--unknown-pct", "40", "--copy"]
    if mode == "archive":
        archive = tmp_path / "gsc.tar.gz"
        with tarfile.open(archive, "w:gz") as tf:
            tf.add(raw, arcname=".")
        src = ["--archive", str(archive)]
    elif mode.startswith("lists"):
        extra += _lists(raw, tmp_path, mode.split("_")[1])
    elif mode == "wanted_words":
        extra += ["--wanted-words", "yes,cat", "--seed", "7", "--validation-pct", "20"]
    jprep.main(src + ["--out", str(tmp_path / "jax")] + extra)
    want_out = capsys.readouterr().out
    tprep.main(src + ["--out", str(tmp_path / "port")] + extra)
    got_out = capsys.readouterr().out
    want, got = _placed(tmp_path / "jax"), _placed(tmp_path / "port")
    assert got == want
    assert {p.split("/")[0] for p in got} == {"train", "valid", "test"}
    assert any("/unknown/" in p for p in got)
    for split in ("train", "valid", "test"):
        assert (tmp_path / "port" / split / "_background_noise_" / "n.wav").exists()
    assert got_out.replace(str(tmp_path / "port"), "") == want_out.replace(
        str(tmp_path / "jax"), "")
    tprep.main(src + ["--out", str(tmp_path / "port")] + extra)
    assert "Placed 0 files" in capsys.readouterr().out


def test_which_set_equals_jax():
    rng = np.random.default_rng(1)
    for _ in range(500):
        name = f"{int(rng.integers(0, 2**32)):08x}_nohash_{int(rng.integers(0, 5))}.wav"
        for pct in ((10, 10), (5, 20), (0, 0)):
            assert tprep.which_set(name, *pct) == jprep.which_set(name, *pct)
    assert tprep.which_set("abc_nohash_0.wav", 10, 10) == tprep.which_set("abc_nohash_7.wav",
                                                                          10, 10)
