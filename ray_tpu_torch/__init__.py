"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

A package of its own beside `ray_tpu`: it imports torch, never jax and
nothing of `ray_tpu`. Plain tensor work goes to PyTorch (cuDNN, cuBLAS);
every kernel that `ray_tpu` wrote by hand in Pallas gets a kernel written
by hand for sm_90a under `ops/csrc/`. Entry points run on CUDA unless the
caller passes `device="cpu"`; with no CUDA device they raise.

The runtime is the port's own copy of ray_tpu's task/actor/object-store
core for one node (GCS, raylet, core worker, object store), with the GPU as a
first-class resource: `init()` counts the cards, `remote(num_gpus=)`
leases them, and the raylet starts each GPU worker with
CUDA_VISIBLE_DEVICES set to the cards of its lease. Its processes and
files carry the port's own names: `python -m ray_tpu_torch...`, sessions
under $TMPDIR/ray_tpu_torch, the object store under
/dev/shm/ray_tpu_torch-<tag of that directory>.

On the runtime stand three training paths through `train.Trainer`, which
runs its ranks in a `TrainWorker` actor (the driver holds none):
`models.resnet` with the batchnorm-backward sums kernel in
`ops.batchnorm`; `models.transformer` (GPT) with the layernorm and
flash-attention forward kernels in `ops.layernorm` and `ops.attention`;
and data-parallel (optionally int8-quantized or ZeRO-sharded) training
over the ranks of a `collective` group, whose allreduce, reduce-scatter
and allgather are the fused ring kernels of
`collective.backends.pallas_backend`.

`rllib` holds RLlib's on-policy path (PG, PPO, A3C, IMPALA): a
`TorchPolicy` learner on the card fed by CPU rollout actors of the
runtime; `python -m ray_tpu_torch.rlbench` measures its env-steps/s.
"""

__version__ = "0.1.0"

from ray_tpu_torch import exceptions
from ray_tpu_torch.actor import ActorClass, ActorHandle, exit_actor
from ray_tpu_torch.api import (
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch.object_ref import ObjectRef

__all__ = [
    "ActorClass",
    "ActorHandle",
    "ObjectRef",
    "__version__",
    "available_resources",
    "cancel",
    "cluster_resources",
    "exceptions",
    "exit_actor",
    "get",
    "get_actor",
    "init",
    "is_initialized",
    "kill",
    "nodes",
    "put",
    "remote",
    "shutdown",
    "wait",
]
