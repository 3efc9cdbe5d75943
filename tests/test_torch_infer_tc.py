"""K4's design on the H100 (csrc/infer.cu), on the CPU: its front end is
K2's tensor-core stage over `mfcc.tc_tile_plan`'s tiles of the batch's
frames, and each utterance's conv stack runs in the block that stores the
last of its rows. The kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3); here:

- the host plan at every preset x geometry x method x DSP dtype the kernel
  served before (availability unchanged; the conv stage's shared memory
  within a block beside every tile size the stage may take), and over a
  sweep of geometries (it serves everything it served);
- a replay of the per-utterance counters over the plan's tiles: each
  utterance reaches `frames` once, in one block, and every counter ends 0;
- the ctypes mirrors of `K4Args` and `K4Conv` field by field;
- the launch's arguments as the wrapper builds them, and the plain version
  on K2's plain feature against the JAX kernel in interpret mode at the
  other geometries.
"""

import ctypes
import dataclasses
import itertools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tcresnet_tpu.ops.pallas import infer as jinfer
from tcresnet_tpu_torch.config import AudioConfig, ModelConfig, get_preset
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.models.tc_resnet import TC_CHANNELS, scaled_channels
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import infer as k4
from tcresnet_tpu_torch.ops.kernels import mfcc
from tests.test_torch_config import to_jax_config

torch.set_num_threads(1)

PRESETS = ("TCResNet8-1.0", "TCResNet8-1.5", "TCResNet14-1.0", "TCResNet14-1.5")
# window / hop in samples at 16 kHz -> (window ms, hop ms)
GEOMETRIES = {"480/160": (30.0, 10.0), "640/320": (40.0, 20.0), "400/200": (25.0, 12.5)}
METHODS = ("mfcc", "log_mel_spectrogram")
DSP_DTYPES = ("float32", "bfloat16")
BATCHES = (1, 3, 8, 64, 256, 1024)

# tolerances of tests/test_pallas_infer.py (as tests/test_torch_infer.py)
LOGIT_TOL = dict(atol=5e-4, rtol=1e-4)
SOFTMAX_ATOL = 1e-5


def _audio(label: str, method: str = "mfcc", dsp_dtype: str = "float32", base=None):
    window_ms, hop_ms = GEOMETRIES[label]
    base = base or get_preset("TCResNet8-1.0").audio
    return dataclasses.replace(base, window_size_ms=window_ms, window_stride_ms=hop_ms,
                               preprocess_method=method, dsp_matmul_dtype=dsp_dtype)


def _fp32_design_available(model_cfg: ModelConfig, audio_cfg: AudioConfig) -> bool:
    """K4's rule before its front end moved to K2's stage: the common front
    end conditions, hop-decomposable, and one utterance in one block (its
    samples, log-mel or three conv buffers; its power spectrum; the pooled
    vector: `FrontEndGeometry.regions`), conv widths in fours."""
    if model_cfg.name not in TC_CHANNELS:
        return False
    n = audio_cfg.desired_samples
    window, hop = audio_cfg.window_size_samples, audio_cfg.window_stride_samples
    if window % hop or n % hop or not mfcc.front_end_supported(audio_cfg, n):
        return False
    g = mfcc.front_end_geometry(audio_cfg, n)
    shapes = k4._conv_shapes(model_cfg, g.frames)
    region_a, region_b = g.regions(3 * max(t * c for t, c in shapes))
    c_last = scaled_channels(model_cfg.name, model_cfg.width_multiplier)[-1]
    return (all(c % 4 == 0 for _, c in shapes) and len(shapes) <= k4._MAX_CONVS
            and 4 * (region_a + region_b + c_last) <= mfcc.SMEM_LIMIT)


@pytest.mark.parametrize("dsp_dtype", DSP_DTYPES)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("label", sorted(GEOMETRIES))
@pytest.mark.parametrize("preset", PRESETS)
def test_host_plan_serves_what_the_fp32_design_served(preset, label, method, dsp_dtype):
    """Available as before; the conv stage's memory (flag, features, three
    buffers, pooled vector) is what the kernel lays out and fits a block,
    and so does every tile the stage may take with it; every batch's launch
    is one of the kernel's three products."""
    cfg = get_preset(preset)
    audio = _audio(label, method, dsp_dtype, cfg.audio)
    assert _fp32_design_available(cfg.model, audio)
    assert k4.fused_infer_available(cfg.model, audio)
    geom = k4._geometry(cfg.model, audio)
    g = geom.fe
    shapes = k4._conv_shapes(cfg.model, g.frames)
    c_last = scaled_channels(cfg.model.name, cfg.model.width_multiplier)[-1]
    feats = g.frames * g.width
    assert geom.act_max == max(t * c for t, c in shapes) and geom.act_max % 4 == 0
    assert geom.conv_floats == 4 + feats + -feats % 4 + 3 * geom.act_max + c_last
    assert geom.nnz == mfcc.tc_mel_constants(*dsp.mel_args(audio))[1].size
    fitting = [r for r in mfcc.TC_TILE_ROWS
               if mfcc.smem_bytes(g, "hops", geom.nnz, r) <= mfcc.SMEM_LIMIT]
    assert 16 in fitting
    for rows in fitting:
        stage = mfcc.smem_bytes(g, "hops", geom.nnz, rows)
        assert max(stage, 4 * geom.conv_floats) <= mfcc.SMEM_LIMIT, rows
    for batch in BATCHES:
        plan = mfcc.tc_tile_plan(batch, g, geom.nnz)
        assert plan.rows in fitting and mfcc.tc_tile_plan(batch, g, geom.nnz) is plan
        smem = k4.launch_smem_bytes(geom, plan)
        assert smem == max(plan.smem_bytes, 4 * geom.conv_floats) <= mfcc.SMEM_LIMIT
        assert plan.rows in (128, 64) or (plan.rows <= 16 and
                                          (plan.tiles < mfcc.SMS or plan.splits == 1))


def test_availability_over_a_sweep_of_geometries():
    """Over windows of 10-64 ms, hops of 5-32 ms, 0.16-2 s clips, MFCC and
    log-mel, two filterbanks and three widths: the kernel serves every
    configuration the FP32 design served, and more (its shared memory no
    longer holds a whole clip)."""
    old = new = 0
    models = [ModelConfig(name="TCResNet8", width_multiplier=w) for w in (0.5, 1.0)]
    models.append(ModelConfig(name="TCResNet14", width_multiplier=1.5))
    for window_ms, hop_ms, n, method, (mels, coefs), model in itertools.product(
            (10, 20, 25, 30, 40, 64), (5, 10, 12.5, 20, 32), (2560, 16000, 32000),
            METHODS, ((40, 10), (40, 40)), models):
        audio = AudioConfig(window_size_ms=window_ms, window_stride_ms=hop_ms,
                            num_mel_bins=mels, num_mfccs=coefs, preprocess_method=method,
                            clip_duration_ms=n // 16)
        served = k4.fused_infer_available(model, audio)
        if _fp32_design_available(model, audio):
            old += 1
            assert served, (window_ms, hop_ms, n, method, mels, coefs, model)
        new += served
    assert old > 200 and new > old


def _replay(batch: int, g: mfcc.FrontEndGeometry, plan: mfcc.TcPlan, order: np.ndarray):
    """The kernel's counters (dft_tc.cuh::tc_tile and tc_frames_features,
    infer.cu::k4_kernel) with the blocks finishing in `order`: [(utterance,
    block)] in the order the conv stacks start, and the counters after."""
    total = batch * g.frames
    done = np.zeros(max(plan.tiles, 1), np.int64)  # split tiles' blocks that finished
    count = np.zeros(batch, np.int64)
    started = []
    for block in order:
        tile = block // plan.splits
        if plan.splits > 1:  # only the tile's last block to finish stores it
            done[tile] += 1
            if done[tile] < plan.splits:
                continue
            done[tile] = 0
        r0 = tile * plan.rows
        end = min(r0 + plan.rows, total)
        b = r0 // g.frames
        while b * g.frames < end:
            rows = min(end, (b + 1) * g.frames) - max(r0, b * g.frames)
            assert rows > 0
            count[b] += rows
            assert count[b] <= g.frames
            if count[b] == g.frames:
                started.append((b, block))
                count[b] = 0
            b += 1
    return started, count, done


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("label", sorted(GEOMETRIES))
def test_counters_start_each_conv_stack_once(label, batch):
    """Over the plan's tiles, in three orders of finishing (in order,
    reversed, shuffled): every utterance reaches `frames` exactly once, in
    the block that stores its last rows, and the counters (per utterance
    and per split tile) end at 0, as the next call needs them. Batch 1 at
    480/160 runs its front end on 28 blocks."""
    audio = _audio(label)
    geom = k4._geometry(get_preset("TCResNet8-1.0").model, audio)
    g = geom.fe
    plan = mfcc.tc_tile_plan(batch, g, geom.nnz)
    assert plan.tiles == -(-batch * g.frames // plan.rows)
    if label == "480/160" and batch == 1:
        assert (plan.rows, plan.grid) == (16, 28)
    rng = np.random.default_rng(batch)
    for order in (np.arange(plan.grid), np.arange(plan.grid)[::-1], rng.permutation(plan.grid)):
        started, count, done = _replay(batch, g, plan, order)
        assert sorted(b for b, _ in started) == list(range(batch))
        assert not count.any() and not done.any()
        position = {block: i for i, block in enumerate(order)}
        for b, block in started:
            # the block is the last to finish of those holding b's rows
            tiles = range(b * g.frames // plan.rows, ((b + 1) * g.frames - 1) // plan.rows + 1)
            last = max(position[t * plan.splits + s] for t in tiles for s in range(plan.splits))
            assert position[block] == last


def _c_fields(struct: str) -> list:
    """[(name, type, pointer, array length)] of a struct in csrc/infer.cu."""
    text = (Path(k4.__file__).resolve().parents[2] / "csrc" / "infer.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, text, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        m = re.match(r"\s*(?:const\s+)?(\w+)\s*(\*?)\s*(.+)", decl.strip())
        if m:
            for name in m.group(3).split(","):
                arr = re.match(r"\s*(\w+)\s*(?:\[(\w+)\])?", name)
                fields.append((arr.group(1), m.group(1), bool(m.group(2)), arr.group(2)))
    return fields


@pytest.mark.parametrize("name", ["K4Args", "K4Conv"])
def test_ctypes_mirror_matches_the_c_struct(name):
    """The ctypes mirror lists the C struct's fields in its order with their
    types (pointers as pointers, the front end's structs as their mirrors,
    the conv table as K4_MAX_CONVS entries): a moved field can keep the
    struct's size, which is all the library's check sees."""
    text = (Path(k4.__file__).resolve().parents[2] / "csrc" / "infer.cu").read_text()
    defines = dict(re.findall(r"#define (K4_\w+) (\d+)", text))
    assert int(defines["K4_MAX_CONVS"]) == k4._MAX_CONVS
    assert int(defines["K4_FLAG"]) == k4._FLAG_FLOATS
    types = {"int": ctypes.c_int, "FeArgs": mfcc.FeArgs, "FeVariant": mfcc.FeVariant,
             "K4Conv": k4._K4Conv}
    want = []
    for field, ctype, pointer, length in _c_fields(name):
        t = ctypes.c_void_p if pointer else types[ctype]
        if length:
            t = t * int(defines[length])
        want.append((field, t))
    got = [(f, t) for f, t in getattr(k4, f"_{name}")._fields_]
    assert [f for f, _ in got] == [f for f, _ in want]
    for (f, t), (_, w) in zip(got, want):
        if issubclass(w, ctypes.Array):
            assert issubclass(t, ctypes.Array) and t._type_ is w._type_ and t._length_ == w._length_, f
        else:
            assert t is w, f


@pytest.mark.parametrize("batch", [1, 3, 1024])
def test_launch_arguments_follow_the_tile_plan(batch):
    """The wrapper's args for a batch: the hops FrontEnd's constants (one
    upload, K2's), this batch's tile plan and samples span, the split
    tiles' workspace where the plan splits, K4's own counters (split tiles:
    its own, not the shared FrontEnd's; utterances: grown to the batch),
    the path (the conv stacks in a kernel of their own for more than one
    utterance, unless forced) with the conv stage's memory, and the conv
    table."""
    cfg = get_preset("TCResNet8-1.0")
    seeded = seeded_variables(cfg.model, dsp.feature_shape(cfg.audio), 0)
    v = variables_from_jax(cfg.model, **seeded)
    plan = k4.build_fused_infer(cfg.model, cfg.audio, v["params"], v["batch_stats"],
                                device="cpu")
    fe = mfcc.front_end(cfg.audio, 16000, "cpu")
    assert plan.fe is fe and plan.done is not fe.done and not plan.done.any()
    g = plan.geom.fe
    wavs = torch.zeros(batch, 16000)
    feats = torch.empty(batch, g.frames, g.width)
    out = torch.empty(batch, cfg.model.num_classes)
    args, part = plan.kernel_args(wavs, feats, out)
    tiles = mfcc.tc_tile_plan(batch, g, plan.geom.nnz)
    assert (args.v.rows, args.v.splits) == (tiles.rows, tiles.splits)
    assert args.region_a == tiles.span and args.batch == batch
    assert args.smem_bytes == k4.launch_smem_bytes(plan.geom, tiles)
    assert args.v.done == plan.done.data_ptr() and args.count == plan.count.data_ptr()
    assert plan.count.numel() >= batch and not plan.count.any()
    assert (args.wavs, args.feats, args.out) == (wavs.data_ptr(), feats.data_ptr(),
                                                out.data_ptr())
    assert args.fe.dft == fe.dft.data_ptr() and args.v.w == fe.dft.data_ptr()
    if tiles.splits > 1:
        assert part.numel() == tiles.tiles * args.v.units * g.num_mel * tiles.rows
        assert args.v.part == part.data_ptr()
    else:
        assert part is None
    assert args.two_kernels == (batch > 1) == plan.two_kernels(batch)
    assert args.conv_bytes == 4 * plan.geom.conv_floats
    for force in (False, True):
        plan.force_two_kernels = force
        assert plan.kernel_args(wavs, feats, out)[0].two_kernels == force
    plan.force_two_kernels = None
    assert args.n_convs == len(plan.convs) == 10
    assert [(args.convs[i].k, args.convs[i].stride, args.convs[i].ci, args.convs[i].co)
            for i in range(3)] == [(3, 1, 40, 16), (1, 2, 16, 24), (9, 2, 16, 24)]


@pytest.mark.parametrize("label,n,method", [("640/320", 2560, "mfcc"),
                                            ("640/320", 2560, "log_mel_spectrogram"),
                                            ("400/200", 3200, "mfcc")])
def test_plain_version_matches_jax_kernel_at_other_geometries(label, n, method):
    """The plain version (K2's plain feature, then the per-tap convs)
    against JAX's K4 in interpret mode at 640/320 and 400/200, batch 3."""
    window_ms, hop_ms = GEOMETRIES[label]
    audio = AudioConfig(clip_duration_ms=n // 16, num_mfccs=20, num_mel_bins=32,
                        window_size_ms=window_ms, window_stride_ms=hop_ms,
                        preprocess_method=method)
    model = ModelConfig(name="TCResNet8", num_classes=12)
    assert jinfer.fused_infer_available(to_jax_config(model), to_jax_config(audio))
    assert k4.fused_infer_available(model, audio)
    seeded = seeded_variables(model, dsp.feature_shape(audio), 3)
    jfn = jinfer.build_fused_infer(to_jax_config(model), to_jax_config(audio), seeded["params"],
                                   seeded["batch_stats"], tb=4, interpret=True)
    v = variables_from_jax(model, **seeded)
    plan = k4.build_fused_infer(model, audio, v["params"], v["batch_stats"], device="cpu")
    wavs = np.random.default_rng(5).uniform(-1, 1, (3, n)).astype(np.float32)
    want = np.asarray(jax.device_get(jfn(wavs)))
    got = plan(torch.tensor(wavs)).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    sm = lambda a: np.asarray(jax.nn.softmax(a, axis=-1))  # noqa: E731
    np.testing.assert_allclose(sm(got), sm(want), atol=SOFTMAX_ATOL)
