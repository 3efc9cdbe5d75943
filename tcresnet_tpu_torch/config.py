"""Dataclass configuration system with named presets.

The port's own copy of tcresnet_tpu/config.py: the port imports nothing
of the JAX package. tests/test_torch_config.py holds the two equal,
preset for preset. The comments say what each value selects in the port;
the card's times of each choice are in PERF.md.

Replaces the reference's distributed-argparse flag tree
(reference train_audio.py:46-67, each layer's `add_arguments`) with
typed dataclasses plus the 15 named experiment presets that mirror
reference scripts/commands/*.sh (see SURVEY.md section 6.2; the
survey counts 14 but the reference ships 15 scripts).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class AudioConfig:
    """Audio + feature front-end settings.

    Defaults mirror reference datasets/audio_data_wrapper.py:60-110.
    """

    sample_rate: int = 16000
    clip_duration_ms: int = 1000
    window_size_ms: float = 30.0
    window_stride_ms: float = 10.0
    lower_edge_hertz: float = 80.0
    upper_edge_hertz: float = 7600.0
    num_mel_bins: int = 64
    num_mfccs: int = 40
    # "mfcc" | "log_mel_spectrogram" | "no_preprocessing"
    # (reference: datasets/preprocessor_factory.py:6-12)
    preprocess_method: str = "mfcc"
    # "xla": the plain front end (framing gather + matmuls; cuBLAS on the
    # card); "pallas": the fused MFCC kernel of the DFT variant (K2, K8 or
    # K9, ops/kernels/mfcc.py; its plain version on the CPU); "auto": the
    # kernel on the card from `ops/kernels/mfcc.AUTO_MIN_BATCH` rows. The
    # card's times of both are in PERF.md.
    dsp_backend: str = "xla"
    # Single-kernel training input path: dataset-row gather + int16
    # decode + augmentation + MFCC in one kernel, K3
    # (ops/kernels/frontend.py), so the augmented waveform never reaches
    # device memory. "auto": on the card from `AUTO_MIN_BATCH` rows
    # whenever the geometry and config allow (MFCC or log-mel, a
    # hop-decomposable window, a noise bank; train/trainer.py); "off"/"on"
    # force. Train path only; eval keeps the shared dsp.preprocess front
    # end. The threshold is the JAX package's; the card's crossover is
    # measured in PERF.md.
    frontend_fuse: str = "auto"
    # dtype of the windowed-DFT matmul operands, the front end's FLOP
    # bulk. "float32" reproduces tf.signal numerics exactly (golden
    # tests); "bfloat16" rounds the DFT's operands to bf16 and keeps the
    # sums in float32 (~3e-3 relative feature error; the kernels' gate is
    # 5e-3). Exports keep float32 unless the training config opted in.
    dsp_matmul_dtype: str = "float32"
    # The fused front end's DFT variant: "hops" (K2; K3-hops), "phases"
    # (K8; on the card K2's tensor-core stage serves both), "radix4" (K9;
    # K3-radix4); a geometry that does not allow the variant takes hops.
    # "auto" resolves to hops, the JAX package's rule
    # (ops/kernels/mfcc.py::resolve_dft_variant); the card's times of each
    # are in PERF.md.
    dft_variant: str = "auto"

    @property
    def desired_samples(self) -> int:
        return int(self.sample_rate * self.clip_duration_ms / 1000)

    @property
    def window_size_samples(self) -> int:
        return int(self.sample_rate * self.window_size_ms / 1000)

    @property
    def window_stride_samples(self) -> int:
        return int(self.sample_rate * self.window_stride_ms / 1000)


@dataclass(frozen=True)
class AugmentConfig:
    """Device-side augmentation settings.

    Reference distributions: datasets/augmentation_factory.py:30-143
    (anchored_slice_or_pad[_with_shift], naive background-mix version).
    """

    # "anchored_slice_or_pad" | "anchored_slice_or_pad_with_shift" |
    # "no_augmentation_audio"
    method: str = "anchored_slice_or_pad_with_shift"
    background_frequency: float = 0.8
    background_max_volume: float = 0.1
    shift_ratio: float = 0.1
    # Background-mix version (augmentation_factory.py:38 naive_version
    # defaults True). naive (v1): training rows mixed at U[0,max_volume)
    # with prob background_frequency. v2 (:81-95): additionally, SILENCE
    # rows are mixed at volume U[0,1) — even at eval.
    naive_background_mix: bool = True
    # -1: auto = num_samples // num_labels
    # (reference: datasets/audio_data_wrapper.py:164-174)
    num_silent: int = -1
    # "auto": the augmentation kernels (K1 on dataset rows, K6 on decoded
    # wavs; ops/kernels/augment.py, bit-identical to the plain version
    # given the same draws) on the card, the plain version elsewhere; or
    # force "xla" (plain) / "pallas" (the kernels; their plain version on
    # the CPU). The card's times of both are in PERF.md.
    backend: str = "auto"
    # Quantize noise-crop start offsets down to a multiple of 1024
    # samples (64 ms), in the kernels and the plain version alike. Off by
    # default: the reference's crop offsets are sample-exact.
    noise_crop_quantize: bool = False


@dataclass(frozen=True)
class ModelConfig:
    """Model selection and per-model hyperparameters.

    Mirrors the per-model argparse flags in
    reference factory/audio_nets.py:205-459.
    """

    name: str = "TCResNet8"
    num_classes: int = 12
    width_multiplier: float = 1.0
    dropout_keep_prob: float = 0.5
    weight_decay: float = 1e-3
    label_smoothing: float = 0.0
    # KWS-family architecture selector
    # (reference: factory/audio_nets.py:220-224)
    kws_architecture: str = "conv"
    # BatchNorm running-stat decay override. None keeps each family's
    # reference default (0.997 TC-ResNet/Res, 0.96 DS-CNN). Short runs
    # (e.g. convergence tests) need a faster decay for usable eval stats.
    bn_momentum: "float | None" = None
    # Temporal (k x 1) conv implementation for the TC-ResNet family:
    # "xla" (default: cuDNN on the card) or "pallas", the hand-written
    # forward and backward kernels K7 (ops/kernels/tconv.py; their plain
    # version on the CPU). "pallas-interpret" runs the plain version on
    # any device (tests); "im2col" raises (not carried over). The card's
    # times of both are in PERF.md.
    conv_backend: str = "xla"


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer + piecewise-constant LR schedule.

    Reference: helper/trainer.py:107-137 (schedule), :171-197 (optimizers),
    :199-222 (EMA).
    """

    optimizer: str = "mom"  # gd | adam | mom | rmsprop
    lr_list: Tuple[float, ...] = (0.1, 0.01, 0.001)
    boundaries: Tuple[int, ...] = (10000, 20000)
    boundaries_epoch: bool = False  # boundaries given in epochs, not steps
    momentum: float = 0.9
    rmsprop_decay: float = 0.9
    adam_epsilon: float = 1e-8
    rmsprop_epsilon: float = 1e-10
    use_ema: bool = False
    ema_decay: float = 0.999
    # Shift LR boundaries forward by the restored step on resume /
    # kept-step warm start (reference helper/trainer.py:120-133).
    relative_schedule: bool = False
    # Regexes over '/'-joined param paths; when non-empty, ONLY matching
    # params receive updates (reference: --trainable_scopes via
    # common/tf_utils.get_variables_to_train, tf_utils.py:19-37).
    trainable_scopes: Tuple[str, ...] = ()


@dataclass(frozen=True)
class TrainConfig:
    """Train-loop settings (reference: helper/trainer.py:462-536)."""

    batch_size: int = 100
    max_step: int = 30000
    # Stop after this many epochs (num_samples // batch_size steps each)
    # if reached before max_step; 0 disables (helper/trainer.py:419-425).
    max_epoch: int = 0
    # FROM-RESTORE stop conditions (reference semantics, helper/
    # trainer.py:419-425,499-506): counted from the step THIS process
    # restored at, not from 0 — a resumed run trains this many more
    # steps/epochs. 0 disables.
    max_step_from_restore: int = 0
    max_epoch_from_restore: int = 0
    step_save_checkpoint: int = 500
    step_evaluation: int = 500
    step_minimum_save: int = 0
    max_to_keep: int = 5
    seed: int = 0
    train_dir: str = "train_dir"
    # Summary cadence tiers (reference: helper/trainer.py:377-391,486-488).
    summary_step_default: int = 10
    summary_step_verbose: int = 2000
    summary_first_n: int = 30
    # DEFAULT-tier summaries start at this step (reference
    # --step_min_summaries, helper/trainer.py:377,503; default 0 = ungated)
    summary_step_min: int = 0
    # Compute dtype for conv/matmul inside the model ("bfloat16" runs
    # them in bf16, on the card's tensor cores; params/batch-stats stay
    # fp32).
    compute_dtype: str = "float32"
    # Train-stream sanity-eval sample count = this * num_classes
    # (reference --class_sampling_factor, helper/trainer.py:507,589-592).
    class_sampling_factor: int = 20


@dataclass(frozen=True)
class DataConfig:
    """Dataset location + eval batch settings.

    Deviation from reference (documented, SURVEY.md section 7.4.7): eval
    uses one batch size with pad+mask of the final partial batch instead
    of split-size-dividing batch sizes (valid 3 / test 39).
    """

    dataset_root: str = ""
    cache_dir: str = ""
    eval_batch_size: int = 512
    # Prepend the `__null__` silence class at index 0 (reference
    # --no-add_null_class to disable, data_wrapper_base.py:259-262).
    add_null_class: bool = True
    # Label-balancing oversampling of the TRAIN split: every label is
    # inflated to at least `ratio * max_label_count` samples (reference
    # --oversampling_ratio, data_wrapper_base.py:219-288). None/0 = off.
    oversampling_ratio: Optional[float] = None
    use_synthetic: bool = False
    synthetic_num_samples: int = 4096
    # Per-class P/R/F1/AP metrics are computed only when the label count
    # is below this (reference --maximum_num_labels_for_metric,
    # metrics/manager.py:9-46; default 10).
    max_labels_for_class_metrics: int = 10
    # Metric names dropped from eval results (reference
    # --exclude_metric_names, metrics/base.py registry exclusion).
    exclude_metric_names: Tuple[str, ...] = ()


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for pjit sharding.

    data: batch (DP) axis; model: reserved TP axis (no-op at size 1 —
    these models are <=500k params; see SURVEY.md section 2.10).
    """

    data: int = -1  # -1: all remaining devices
    model: int = 1


@dataclass(frozen=True)
class ExperimentConfig:
    audio: AudioConfig = field(default_factory=AudioConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **sections) -> "ExperimentConfig":
        return dataclasses.replace(self, **sections)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "ExperimentConfig":
        d = json.loads(s)

        def mk(cls, key):
            sub = d.get(key, {})
            fields = {f.name for f in dataclasses.fields(cls)}
            kwargs = {k: v for k, v in sub.items() if k in fields}
            for f in dataclasses.fields(cls):
                if f.name in kwargs and isinstance(kwargs[f.name], list):
                    kwargs[f.name] = tuple(kwargs[f.name])
            return cls(**kwargs)

        return ExperimentConfig(
            audio=mk(AudioConfig, "audio"),
            augment=mk(AugmentConfig, "augment"),
            model=mk(ModelConfig, "model"),
            optim=mk(OptimConfig, "optim"),
            train=mk(TrainConfig, "train"),
            data=mk(DataConfig, "data"),
            mesh=mk(MeshConfig, "mesh"),
        )


def plain_config(cfg: ExperimentConfig) -> ExperimentConfig:
    """`cfg` on its plain path, the same function: the per-op convs and
    front end, the plain augmentation and no fused front end, so that
    every operation is a PyTorch operator. It is what torch.export traces
    and `utils.profiling`'s FLOP count sees (a kernel's ctypes launch is
    neither). On a card batch norm in training mode and the depthwise 3x3
    convs still run their kernels (`ops/kernels/batchnorm.py`,
    `ops/kernels/dwconv.py`): batch norm's work counts no FLOPs, the
    convs' operators count as the composition they replace, and export
    traces eval mode and, for the convs, the composition."""
    return cfg.replace(
        model=dataclasses.replace(cfg.model, conv_backend="xla"),
        audio=dataclasses.replace(cfg.audio, dsp_backend="xla", frontend_fuse="off"),
        augment=dataclasses.replace(cfg.augment, backend="xla"),
    )


# ---------------------------------------------------------------------------
# Named presets: the 15 reproduction configs from scripts/commands/*.sh
# (SURVEY.md section 6.2). Common flags (scripts/commands/*.sh:3-7):
# 12 classes, train augment anchored_slice_or_pad_with_shift, eval augment
# anchored_slice_or_pad with background_frequency 0.0, ckpt+eval every 500,
# max_to_keep 20. DELIBERATE DEVIATION: the scripts express the training
# budget as --max_step_from_restore N (a resumed-after-completion run
# trains N MORE steps); presets use an absolute max_step=N so resume
# always converges to the paper's total step count — pass
# --cfg train.max_step_from_restore=N --cfg train.max_step=0 for the
# literal script behavior.
# ---------------------------------------------------------------------------

_MFCC_40_3010 = AudioConfig(window_size_ms=30.0, window_stride_ms=10.0, num_mfccs=40)
_MFCC_40_4020 = AudioConfig(window_size_ms=40.0, window_stride_ms=20.0, num_mfccs=40)
_MFCC_10_4020 = AudioConfig(window_size_ms=40.0, window_stride_ms=20.0, num_mfccs=10)

_TC_OPTIM = OptimConfig(
    optimizer="mom", momentum=0.9, lr_list=(0.1, 0.01, 0.001), boundaries=(10000, 20000)
)
_RES_OPTIM = OptimConfig(optimizer="adam", lr_list=(0.1, 0.01, 0.001), boundaries=(3000, 6000))
_DSCNN_OPTIM = OptimConfig(optimizer="adam", lr_list=(5e-4, 1e-4), boundaries=(10000,))
_KWS_FSTRIDE4_OPTIM = OptimConfig(
    optimizer="adam", lr_list=(5e-4, 1e-4, 2e-5), boundaries=(10000, 20000)
)
_KWS_FPOOL3_OPTIM = OptimConfig(optimizer="adam", lr_list=(5e-4, 1e-4), boundaries=(10000,))


def _tc(name: str, wm: float) -> ExperimentConfig:
    return ExperimentConfig(
        audio=_MFCC_40_3010,
        model=ModelConfig(name=name, width_multiplier=wm, weight_decay=1e-3),
        optim=_TC_OPTIM,
        train=TrainConfig(batch_size=100, max_step=30000, max_to_keep=20),
    )


def _res(name: str) -> ExperimentConfig:
    return ExperimentConfig(
        audio=_MFCC_40_3010,
        model=ModelConfig(name=name, weight_decay=1e-5),
        optim=_RES_OPTIM,
        train=TrainConfig(batch_size=64, max_step=9000, max_to_keep=20),
    )


def _dscnn(name: str) -> ExperimentConfig:
    return ExperimentConfig(
        audio=_MFCC_10_4020,
        model=ModelConfig(name=name, weight_decay=0.0),
        optim=_DSCNN_OPTIM,
        train=TrainConfig(batch_size=100, max_step=20000, max_to_keep=20),
    )


PRESETS = {
    "TCResNet8-1.0": _tc("TCResNet8", 1.0),
    "TCResNet8-1.5": _tc("TCResNet8", 1.5),
    "TCResNet14-1.0": _tc("TCResNet14", 1.0),
    "TCResNet14-1.5": _tc("TCResNet14", 1.5),
    "TCResNet2D8-1.0": _tc("ResNet2D8", 1.0),
    "TCResNet2D8Pool-1.0": _tc("ResNet2D8Pool", 1.0),
    "Res8": _res("Res8"),
    "Res8Narrow": _res("Res8Narrow"),
    "Res15": _res("Res15"),
    "Res15Narrow": _res("Res15Narrow"),
    "DSCNNS": _dscnn("DSCNNS"),
    "DSCNNM": _dscnn("DSCNNM"),
    "DSCNNL": _dscnn("DSCNNL"),
    "KWSfstride4": ExperimentConfig(
        audio=_MFCC_40_4020,
        model=ModelConfig(name="KWS", kws_architecture="one_fstride4", weight_decay=0.0),
        optim=_KWS_FSTRIDE4_OPTIM,
        train=TrainConfig(batch_size=100, max_step=30000, max_to_keep=20),
    ),
    "KWSfpool3": ExperimentConfig(
        audio=_MFCC_40_4020,
        model=ModelConfig(name="KWS", kws_architecture="trad_fpool3", weight_decay=0.0),
        optim=_KWS_FPOOL3_OPTIM,
        train=TrainConfig(batch_size=100, max_step=20000, max_to_keep=20),
    ),
}


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"Unknown preset {name!r}. Available: {sorted(PRESETS)}")
    return PRESETS[name]
