"""Trainer and TrainWorker; port of ray_tpu/train/trainer.py (reference:
python/ray/util/sgd/torch/torch_trainer.py).

The JAX Trainer runs each TrainWorker as an actor of the ray_tpu runtime
and moves weights and metrics over its object store. The port keeps its
own copy of what it needs and has not ported that runtime yet (a later
slice, ROADMAP.md queue A), so here the Trainer holds its one TrainWorker
in the calling process. The surface is the JAX one: `train`, `validate`,
`state_dict`, `load_state_dict`, `shutdown`, and `_reduce` over worker
results.
"""

from __future__ import annotations

import torch

from ray_tpu_torch._private.device import resolve_device


class TrainWorker:
    """Wraps one TrainingOperator (reference: distributed_torch_runner.py
    DistributedTorchRunner)."""

    def __init__(self, operator_cls, config: dict, world_rank: int,
                 world_size: int, device: torch.device):
        self._operator_cls = operator_cls
        self._config = config
        self._rank = world_rank
        self._world_size = world_size
        self._device = device
        self.operator = None

    def setup_operator(self):
        self.operator = self._operator_cls(
            self._config, self._rank, self._world_size, device=self._device)
        return True

    def train_epoch(self, num_steps=None):
        return self.operator.train_epoch(num_steps)

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
    """Single-worker trainer (reference: torch_trainer.py:39).

    device: None runs on the current CUDA device and raises without one;
    "cpu" must be asked for by name. resources_per_worker names what the
    worker holds; a CUDA worker needs {"GPU": 1}, and no more GPUs than
    the machine has."""

    def __init__(self, training_operator_cls, *, num_workers: int = 1,
                 config: dict | None = None,
                 resources_per_worker: dict | None = None,
                 sharded: bool = False, mesh_mode: str | None = None,
                 device=None):
        if num_workers > 1:
            raise NotImplementedError(
                "num_workers > 1: multi-GPU data-parallel training is a "
                "later slice (ROADMAP.md queue A, 'Multi-GPU data-parallel "
                "and ZeRO training')")
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if sharded:
            raise NotImplementedError(
                "sharded=True: the ZeRO weight-update schedule is a later "
                "slice (ROADMAP.md queue A, 'Multi-GPU data-parallel and "
                "ZeRO training')")
        if mesh_mode is not None:
            raise NotImplementedError(
                f"mesh_mode={mesh_mode!r}: the FSDP mesh is a later slice "
                "(ROADMAP.md queue A, 'Multi-GPU data-parallel and ZeRO "
                "training')")
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
        worker = TrainWorker(training_operator_cls, dict(config or {}), 0, 1,
                             self._device)
        worker.setup_operator()
        self.workers = [worker]

    def train(self, num_steps: int | None = None) -> dict:
        results = [w.train_epoch(num_steps) for w in self.workers]
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
