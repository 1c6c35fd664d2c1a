"""rlipv2_tpu_torch — the PyTorch/CUDA port of rlipv2_tpu for NVIDIA Hopper.

The package mirrors the layout and module names of `rlipv2_tpu/`, so each
module here has a JAX counterpart at the same relative path. It imports
torch and never jax or flax, and nothing of `rlipv2_tpu`: the host code it
needs (config, vocabulary, loader, batch building, the HICO evaluator) is
its own copy.

Layering (bottom-up):
  ops/       boxes, positional encodings, multi-scale deformable attention
             (plain PyTorch version + hand-written CUDA forward and
             backward kernels for sm_90a).
  models/    nn.Modules with the reference torch state-dict key names:
             ResNet, RoBERTa, ALIF fusion encoder, DAB decoders, RLIP-ParSeDA.
  losses/    the Hungarian matcher, RLIPv2's triplet filter and
             SetCriterionHOI.
  eval/      HOI post-processing and the HICO-DET evaluator.
  engine/    the train step, optimizer, train and evaluation loops, and
             JAX -> torch weight conversion.
  data/      batch building, the HICO-DET and VG-format datasets, image
             reading, augmentations, a seeded synthetic HICO-like dataset
             and a hash tokenizer.
  utils/     metric logging.
  tools/     the golden-pack check, the main paths' model and data, seeded
             HICO and VG-format trees, and the forward, train-step,
             fine-tune and pre-training profilers.
"""

__version__ = "0.1.0"
