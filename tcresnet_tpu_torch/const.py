"""Framework-wide constants (the port's own copy of tcresnet_tpu/const.py).

Reference parity: reference const.py:1-9 (NULL_CLASS_LABEL,
BACKGROUND_NOISE_DIR_NAME).
"""

# Label used for the injected silence class; sorted first so it gets index 0
# (reference: const.py:8, datasets/data_wrapper_base.py get_label_names).
NULL_CLASS_LABEL = "__null__"

# Directory holding background-noise wavs inside each split
# (reference: const.py:9).
BACKGROUND_NOISE_DIR_NAME = "_background_noise_"

# Canonical 12-class Speech Commands v1 label set used by all presets
# (10 keywords + unknown + silence), silence sorted first by the `__`
# prefix, matching the reference's sorted-label-dir convention
# (reference: datasets/data_wrapper_base.py:114-145).
GSC_V1_LABELS = (
    NULL_CLASS_LABEL,
    "down",
    "go",
    "left",
    "no",
    "off",
    "on",
    "right",
    "stop",
    "unknown",
    "up",
    "yes",
)
