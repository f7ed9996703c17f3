"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

A package of its own beside `ray_tpu`: it imports torch, never jax and
nothing of `ray_tpu`. Plain tensor work goes to PyTorch (cuDNN, cuBLAS);
every kernel that `ray_tpu` wrote by hand in Pallas gets a kernel written
by hand for sm_90a under `ops/csrc/`. Entry points run on CUDA unless the
caller passes `device="cpu"`; with no CUDA device they raise.

The port grows slice by slice (ROADMAP.md). This slice holds the ResNet
training path: `models.resnet`, `train.TrainingOperator`, `train.Trainer`
and the batchnorm-backward sums kernel in `ops.batchnorm`.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
