"""tcresnet_tpu_torch — the PyTorch/CUDA port of tcresnet_tpu.

A second package beside the JAX one (`tcresnet_tpu`, the reference). It
mirrors the JAX package's module names so each counterpart is easy to
find, and it imports `torch` and never `jax`, `flax`, `optax` or
`orbax`, nor any module of the JAX package. It keeps its own copies of
the JAX package's stdlib-only modules: `config` (the 15 presets),
`const` and `metrics.writers`; tests/test_torch_config.py holds the
presets equal to the JAX package's.

What the port serves today: every one of the 15 presets, wav -> softmax
through `serve.export.build_inference_fn`. On a CUDA tensor the "fused"
backend runs the temporal TC-ResNets in one hand-written CUDA kernel
(`csrc/infer.cu`) and the 2D families (TCResNet2D8[Pool], Res, DS-CNN,
KWS) in two: the MFCC front end (`csrc/mfcc.cu`) and the op-list
interpreter (`csrc/infer2d.cu`), all built with nvcc at first use. On a
CPU tensor the same entry point runs the kernels' plain PyTorch versions.
Nothing on the GPU path falls back to the CPU.
"""

__version__ = "0.1.0"
