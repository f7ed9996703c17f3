"""Trainer and TrainWorker; port of ray_tpu/train/trainer.py (reference:
python/ray/util/sgd/torch/torch_trainer.py).

The JAX Trainer runs each TrainWorker as an actor of the ray_tpu runtime
and moves weights and metrics over its object store. The port keeps its
own copy of what it needs and has not ported that runtime yet (ROADMAP.md
A4), so here the Trainer holds its TrainWorkers in the calling process.
With num_workers > 1 they are the ranks of one collective group of this
process (collective/collective.py): rank r on cuda:(r % device_count),
each on its own CUDA stream, so on a machine with one card every rank
shares it. `train()` steps the ranks in lockstep: step k's collective of
every rank is launched before any rank goes on past its own, and the
host syncs once per epoch. The surface is the JAX one: `train`,
`validate`, `state_dict`, `load_state_dict`, `shutdown`, and `_reduce`
over worker results.
"""

from __future__ import annotations

import itertools

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.collective import collective as col
from ray_tpu_torch.collective.types import normalize_quantize
from ray_tpu_torch.train.operator import lockstep

_GROUP_IDS = itertools.count()


class TrainWorker:
    """Wraps one TrainingOperator (reference: distributed_torch_runner.py
    DistributedTorchRunner)."""

    def __init__(self, operator_cls, config: dict, world_rank: int,
                 world_size: int, device: torch.device,
                 group_name: str | None = None):
        self._operator_cls = operator_cls
        self._config = config
        self._rank = world_rank
        self._world_size = world_size
        self._device = device
        self._group_name = group_name
        self.handle = None
        self.operator = None

    def init_collective_group(self, world_size, rank, backend, group_name,
                              timeout, quantize, transport):
        """Joins the worker's rank to the group (reference: the actor's
        __ray_collective_init__)."""
        self.handle = col.init_collective_group(
            world_size, rank, backend, group_name, timeout, transport,
            quantize, device=self._device)
        return True

    def setup_operator(self):
        self.operator = self._operator_cls(
            self._config, self._rank, self._world_size, device=self._device,
            group_name=self._group_name)
        return True

    def train_epoch(self, num_steps=None):
        return self.operator.train_epoch(num_steps)

    def train_epoch_stages(self, num_steps=None):
        return self.operator.train_epoch_stages(num_steps)

    def validate(self, num_steps=None):
        return self.operator.validate(num_steps)

    def state_dict(self):
        return self.operator.state_dict()

    def load_state_dict(self, state):
        self.operator.load_state_dict(state)
        return True

    def shutdown(self):
        self.operator = None


class Trainer:
    """Data-parallel trainer (reference: torch_trainer.py:39).

    device: None runs on CUDA and raises without it; "cpu" must be asked
    for by name. resources_per_worker names what a worker holds; a CUDA
    worker needs {"GPU": 1}, and no more GPUs than the machine has.

    num_workers > 1: the ranks of one collective group over
    `collective_transport` ("auto" and "pallas": the fused ring kernels;
    the other tiers are not ported and raise), with `collective_timeout`
    seconds for a rank to wait on a peer. quantize="int8" makes the
    gradient wire block-scaled int8 (EQuARX-style, lossy). sharded=True
    turns on the ZeRO weight-update schedule (arXiv:2004.13336):
    reducescatter(grads), the optimizer on the rank's 1/N flat span,
    allgather(params). mesh_mode (FSDP) is a later slice."""

    def __init__(self, training_operator_cls, *, num_workers: int = 1,
                 config: dict | None = None,
                 resources_per_worker: dict | None = None,
                 collective_timeout: float = 30.0,
                 quantize: str | None = None,
                 collective_transport: str = "auto",
                 sharded: bool = False, mesh_mode: str | None = None,
                 device=None):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self._config = dict(config or {})
        if sharded:
            if mesh_mode is not None:
                raise ValueError(
                    "sharded=True (collective ZeRO) and mesh_mode (SPMD) "
                    "are mutually exclusive update plans")
            self._config["sharded_update"] = True
        if mesh_mode is not None:
            raise NotImplementedError(
                f"mesh_mode={mesh_mode!r}: the FSDP mesh is a later slice "
                "(ROADMAP.md queue A item 5)")
        quantize = normalize_quantize(quantize)
        col.resolve_transport(collective_transport)
        self._device = resolve_device(device)
        on_cuda = self._device.type == "cuda"
        resources = resources_per_worker or ({"GPU": 1} if on_cuda
                                             else {"CPU": 1})
        gpus = resources.get("GPU", 0)
        if gpus > torch.cuda.device_count():
            raise ValueError(
                f"resources_per_worker asks for {gpus} GPU(s); this machine "
                f"has {torch.cuda.device_count()}")
        if on_cuda and gpus < 1:
            raise ValueError(
                f"a worker on {self._device} needs resources_per_worker "
                "{'GPU': 1}")
        self._last_state: dict | None = None
        if num_workers == 1:
            self._group_name = None
            devices = [self._device]
        else:
            self._group_name = f"trainer_{next(_GROUP_IDS)}"
            devices = col.rank_devices(num_workers,
                                       None if on_cuda else self._device)
        self.workers = [TrainWorker(training_operator_cls, self._config, r,
                                    num_workers, devices[r],
                                    self._group_name)
                        for r in range(num_workers)]
        try:
            if self._group_name is not None:
                col.create_collective_group(
                    self.workers, num_workers, list(range(num_workers)),
                    backend="host", group_name=self._group_name,
                    timeout=collective_timeout, quantize=quantize,
                    transport=collective_transport)
            for w in self.workers:
                w.setup_operator()
        except BaseException:
            self.shutdown()
            raise

    def train(self, num_steps: int | None = None) -> dict:
        """One epoch on every worker, in lockstep; the mean of their
        results (sums of counts and throughput)."""
        results = lockstep([w.train_epoch_stages(num_steps)
                            for w in self.workers])
        self._last_state = self.workers[0].state_dict()
        return _reduce(results)

    def validate(self, num_steps: int | None = None) -> dict:
        return _reduce([w.validate(num_steps) for w in self.workers])

    def state_dict(self) -> dict:
        return self.workers[0].state_dict()

    def load_state_dict(self, state: dict):
        self._last_state = state
        for w in self.workers:
            w.load_state_dict(state)

    def shutdown(self):
        """Waits for every rank's work, frees the group and the workers."""
        if self._group_name is not None:
            col.destroy_collective_group(self._group_name)
        for w in self.workers:
            w.shutdown()
        self.workers = []


def _reduce(results: list[dict]) -> dict:
    """Average worker metrics; sum sample counts/throughput."""
    if not results:
        return {}
    out = {}
    for k in results[0]:
        vals = [r[k] for r in results if k in r]
        if k in ("num_samples", "samples_per_s", "batch_count"):
            out[k] = type(vals[0])(sum(vals))
        elif isinstance(vals[0], (int, float)):
            out[k] = sum(vals) / len(vals)
        else:
            out[k] = vals[0]
    return out
