"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

A package of its own beside `ray_tpu`: it imports torch, never jax and
nothing of `ray_tpu`. Plain tensor work goes to PyTorch (cuDNN, cuBLAS);
every kernel that `ray_tpu` wrote by hand in Pallas gets a kernel written
by hand for sm_90a under `ops/csrc/`. Entry points run on CUDA unless the
caller passes `device="cpu"`; with no CUDA device they raise.

The port grows slice by slice (ROADMAP.md). It holds three training
paths through `train.Trainer` and `train.TrainingOperator`:
`models.resnet` with the batchnorm-backward sums kernel in
`ops.batchnorm`; `models.transformer` (GPT) with the layernorm and
flash-attention forward kernels in `ops.layernorm` and `ops.attention`;
and data-parallel (optionally int8-quantized or ZeRO-sharded) training
over the ranks of a `collective` group, whose allreduce, reduce-scatter
and allgather are the fused ring kernels of
`collective.backends.pallas_backend`.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
