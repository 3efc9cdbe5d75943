"""The port's C++ batch wav decoder (tcresnet_tpu_torch/csrc/wav_decoder.cc,
built with g++ here) against the JAX package's numpy decoder, on the cases
of tests/test_native.py, and the numpy fallback when no library builds."""

import struct
import wave

import numpy as np
import pytest

from tcresnet_tpu.data import wav as jwav
from tcresnet_tpu_torch.data import native_loader
from tcresnet_tpu_torch.data import speech_commands as sc
from tcresnet_tpu_torch.data import wav as twav
from tcresnet_tpu_torch.ops.kernels import _build


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate([16000, 8000, 24000]):  # exact, short, long
        p = root / f"{i}.wav"
        jwav.write_wav_pcm16(p, rng.uniform(-0.9, 0.9, n).astype(np.float32))
        paths.append(str(p))
    return paths


def _odd_fmt_wav(path):
    """A PCM16 wav whose fmt chunk is 17 bytes, so a pad byte follows it."""
    data = np.arange(-50, 50, dtype=np.int16).tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, 16000, 32000, 2, 16) + b"\x07"
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"\x00"
            + b"data" + struct.pack("<I", len(data)) + data)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return str(path)


def _stereo_wav(path):
    left = (np.arange(100) * 100).astype(np.int16)
    inter = np.empty(200, np.int16)
    inter[0::2], inter[1::2] = left, -7
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(inter.tobytes())
    return str(path)


def test_library_builds_with_gxx():
    assert native_loader.available(), "the C++ decoder did not build or load"
    assert _build.host_library_path("wav_decoder").exists()


@pytest.mark.parametrize("desired", [16000, 4000, 30000])
def test_decode_batch_equals_jax_numpy_decoder(wav_files, desired):
    before = native_loader.files_decoded
    got = native_loader.decode_batch(wav_files, desired)
    assert got.shape == (3, desired) and got.dtype == np.int16
    assert native_loader.files_decoded == before + 3
    for i, p in enumerate(wav_files):
        np.testing.assert_array_equal(got[i], jwav.decode_wav_int16(p, desired)[0])


@pytest.mark.parametrize("case", ["odd_fmt_pad_byte", "stereo_first_channel"])
def test_special_layouts_equal_jax_numpy_decoder(tmp_path, case):
    make = _odd_fmt_wav if case == "odd_fmt_pad_byte" else _stereo_wav
    path = make(tmp_path / f"{case}.wav")
    want, rate = jwav.decode_wav_int16(path, 100)
    assert rate == 16000
    np.testing.assert_array_equal(native_loader.decode_batch([path], 100)[0], want)
    np.testing.assert_array_equal(twav.decode_wav_int16(path, 100)[0], want)
    # the sample count before any crop, as the numpy decoder reads it (the
    # JAX package's C++ probe reads the odd fmt chunk's file as 0 samples)
    assert native_loader.wav_num_samples(path) == jwav.decode_wav_int16(path)[0].shape[0]


def test_wav_num_samples(wav_files):
    assert [native_loader.wav_num_samples(p) for p in wav_files] == [16000, 8000, 24000]
    assert native_loader.wav_num_samples("/nonexistent.wav") is None


def test_bad_file_and_wrong_rate_raise(tmp_path, wav_files):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"this is not a wav file at all...")
    with pytest.raises(ValueError, match="failed to decode"):
        native_loader.decode_batch([wav_files[0], str(bad)], 16000)
    with pytest.raises(ValueError, match=r"rc=-4"):
        native_loader.decode_batch(wav_files, 16000, expected_rate=8000)
    # the loader surfaces the native diagnosis instead of decoding again
    with pytest.raises(ValueError, match="failed to decode"):
        sc._decode_all([wav_files[0], str(bad)], 16000)


_BLOBS = {
    "empty": b"",
    "short": b"RIFF",
    "riff_only": b"RIFF\x00\x00\x00\x00WAVE",
    "huge_fmt": b"RIFF$\x00\x00\x00WAVEfmt " + (0xFFFFFFF0).to_bytes(4, "little")
                + b"\x01\x00\x01\x00",
    "zero_chunks": b"RIFF" + (100).to_bytes(4, "little") + b"WAVE"
                   + b"junk\x00\x00\x00\x00" * 10,
    **{f"rand{i}": np.random.default_rng(i).bytes(int(np.random.default_rng(i).integers(10, 3000)))
       for i in range(4)},
}


@pytest.mark.parametrize("name", sorted(_BLOBS))
def test_malformed_wavs_rejected_cleanly(tmp_path, name):
    """A malformed file comes back as a per-file status (ValueError), never
    a crash inside the ctypes call."""
    p = tmp_path / f"{name}.wav"
    p.write_bytes(_BLOBS[name])
    with pytest.raises(ValueError):
        native_loader.decode_batch([str(p)], 1000)


def test_numpy_fallback_when_the_library_cannot_build(monkeypatch, wav_files, caplog):
    """No compiler: available() is False, decode_batch returns None, the
    fallback is logged, and the loader decodes with numpy to the same bits."""
    want = native_loader.decode_batch(wav_files, 16000)

    def no_compiler(name):
        raise RuntimeError("g++ not found")

    native_loader._load.cache_clear()
    monkeypatch.setattr(_build, "build_host", no_compiler)
    try:
        with caplog.at_level("WARNING", logger="tcresnet_tpu_torch.native"):
            assert not native_loader.available()
        assert "decoding with numpy" in caplog.text
        assert native_loader.decode_batch(wav_files, 16000) is None
        assert native_loader.wav_num_samples(wav_files[0]) is None
        np.testing.assert_array_equal(sc._decode_all(wav_files, 16000), want)
    finally:
        native_loader._load.cache_clear()
        monkeypatch.undo()
    assert native_loader.available()
