"""Trainer and TrainWorker; port of ray_tpu/train/trainer.py (reference:
python/ray/util/sgd/torch/torch_trainer.py).

Each rank runs in a `TrainWorker` actor of the port's runtime, a process
of its own that the raylet pins to the cards of its lease
(CUDA_VISIBLE_DEVICES), so the rank computes on cuda:0 of its own view;
the driver holds no rank, and weights, results and metrics cross the
object store. Call `ray_tpu_torch.init()` first.

One rank is one actor with {"GPU": 1} ({"CPU": 1} for device="cpu"),
exactly the reference's TrainWorker; where the ranks outnumber the node's
cards, k ranks share a card, each with {"GPU": 1/k}. N > 1 ranks are the
ranks of one collective group (backend "host", one rank a process),
created over the workers with `create_collective_group`, as the
reference's `_start_workers` does (trainer.py:293-331). Its data plane is
chosen per op: the fused ring kernels across processes on the card, the
host tiers on the CPU. The surface is the JAX one: `train`, `validate`,
`state_dict`, `load_state_dict`, `shutdown`, and `_reduce` over the
ranks' results.
"""

from __future__ import annotations

import importlib
import itertools
import math
import os
import pickle
import time

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch._private.device import check_device, resolve_device
from ray_tpu_torch.collective import collective as col
from ray_tpu_torch.collective.types import Transport, normalize_quantize

_GROUP_IDS = itertools.count()

# The kernels' launch counters are module globals of the ops modules, so
# they count in the process that launches them: the worker's. Name ->
# (module, attribute), as TrainWorker.read_counter reads them.
KERNEL_COUNTERS = {
    "bn_bwd_sums": ("ray_tpu_torch.ops.batchnorm", "LAUNCHES"),
    "bn_dy_relayouts": ("ray_tpu_torch.ops.batchnorm", "RELAYOUTS"),
    "layernorm": ("ray_tpu_torch.ops.layernorm", "LAYERNORM_LAUNCHES"),
    "rmsnorm": ("ray_tpu_torch.ops.layernorm", "RMSNORM_LAUNCHES"),
    "flash_attn_fwd": ("ray_tpu_torch.ops.attention", "LAUNCHES"),
    "flash_dense_routes": ("ray_tpu_torch.ops.attention", "DENSE_ROUTES"),
    "ring_allreduce": ("ray_tpu_torch.collective.backends.pallas_backend",
                       "ALLREDUCE_LAUNCHES"),
    "ring_reducescatter": (
        "ray_tpu_torch.collective.backends.pallas_backend",
        "REDUCESCATTER_LAUNCHES"),
    "ring_allgather": ("ray_tpu_torch.collective.backends.pallas_backend",
                       "ALLGATHER_LAUNCHES"),
    "quantized_allreduce": (
        "ray_tpu_torch.collective.backends.pallas_backend",
        "QUANTIZED_LAUNCHES"),
    "collective.quantized_bytes_saved_total": (
        "ray_tpu_torch.collective.metrics", "QUANT_SAVED"),
    **{f"collective.{tier}_ops_total": (
        "ray_tpu_torch.collective.metrics", f"{tier.upper()}_OPS")
       for tier in ("hub", "ring", "shm", "device", "pallas")},
}


class TrainWorker(col.CollectiveActorMixin):
    """Actor hosting one rank's TrainingOperator (reference:
    distributed_torch_runner.py DistributedTorchRunner)."""

    def __init__(self, operator_cls_pickled: bytes, config: dict,
                 world_rank: int, world_size: int, group_name: str | None,
                 device: str | None, num_cpus: float):
        self._operator_cls = pickle.loads(operator_cls_pickled)
        self._config = config
        self._rank = world_rank
        self._world_size = world_size
        self._group_name = group_name
        self._device = device
        self._num_cpus = num_cpus
        self.operator = None

    def setup_operator(self) -> int:
        """Builds the rank (after the group, when there is one); returns
        the worker's pid, which Trainer.shutdown waits on. A CPU worker
        computes on the CPUs it leased: torch's threads are that many, so
        its float sums keep one order whatever else runs on the host."""
        if self._device == "cpu":
            import torch

            torch.set_num_threads(max(1, int(self._num_cpus)))
        self.operator = self._operator_cls(
            self._config, self._rank, self._world_size,
            device=resolve_device(self._device),
            group_name=self._group_name)
        return os.getpid()

    def train_epoch(self, num_steps=None, profile_dir=None) -> dict:
        """One epoch of the rank; its result. With profile_dir, a
        torch.profiler chrome trace of the epoch goes to
        profile_dir/train_epoch_<epoch>_rank<r>.json."""
        if not profile_dir:
            return self.operator.train_epoch(num_steps)
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.operator.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            result = self.operator.train_epoch(num_steps)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            profile_dir,
            f"train_epoch_{self.operator.epoch}_rank{self._rank}.json"))
        return result

    def validate(self, num_steps=None) -> dict:
        return self.operator.validate(num_steps)

    def state_dict(self):
        return self.operator.state_dict()

    def load_state_dict(self, state):
        self.operator.load_state_dict(state)
        return True

    def opt_shard_state(self) -> dict:
        return self.operator.opt_shard_state()

    def load_opt_shard(self, shard: dict):
        self.operator.load_opt_shard(shard)
        return True

    def read_counter(self, name: str) -> float:
        """A counter of this worker's process: a kernel's launches or a
        collective tier's ops (KERNEL_COUNTERS, the rank's), or a runtime
        metric."""
        if name in KERNEL_COUNTERS:
            module, attr = KERNEL_COUNTERS[name]
            return float(getattr(importlib.import_module(module), attr))
        from ray_tpu_torch._private import stats

        snap = stats.snapshot().get(name)
        return float(snap["value"]) if snap else 0.0

    def read_metric(self, name: str):
        """Full metric snapshot (histograms/gauges, not just counter
        values)."""
        from ray_tpu_torch._private import stats

        return stats.snapshot().get(name)

    def peak_rss(self) -> int:
        """Peak RSS of this worker process in bytes."""
        import resource
        import sys

        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(ru if sys.platform == "darwin" else ru * 1024)

    def run(self, fn):
        """fn([operator]), this worker's rank's TrainingOperator in a
        list, run in this worker's process: for checks and tools that
        must see a rank's model or its process state (device memory,
        counters)."""
        return fn([self.operator])

    def shutdown(self):
        """Frees the group and ends the process (its card memory goes
        with it)."""
        if self._group_name is not None and col.is_group_initialized(
                self._group_name):
            col.destroy_collective_group(self._group_name)
        self.operator = None
        ray_tpu_torch.exit_actor()


class Trainer:
    """Data-parallel trainer (reference: torch_trainer.py:39).

    device: None runs on CUDA and raises without it; "cpu" must be asked
    for by name. resources_per_worker names what one rank holds; a CUDA
    rank needs {"GPU": 1}, and no more GPUs than the cluster has.

    num_workers > 1: one TrainWorker actor a rank, the ranks of one
    collective group over `collective_transport` ("auto" routes each op by
    the group's vote: the fused ring kernels for CUDA gradients, the host
    tiers on the CPU; a named tier is forced), with `collective_timeout`
    seconds for a rank to wait on a peer. quantize="int8" makes the
    gradient wire block-scaled int8 (EQuARX-style, lossy) on the tiers
    that have a wire. sharded=True turns on the ZeRO weight-update
    schedule (arXiv:2004.13336): reducescatter(grads), the optimizer on
    the rank's 1/N flat span, allgather(params). mesh_mode (FSDP) is a
    later slice."""

    def __init__(self, training_operator_cls, *, num_workers: int = 1,
                 config: dict | None = None,
                 resources_per_worker: dict | None = None,
                 collective_timeout: float = 30.0,
                 setup_timeout: float = 600.0,
                 quantize: str | None = None,
                 collective_transport: str = "auto",
                 sharded: bool = False, mesh_mode: str | None = None,
                 device=None):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self._config = dict(config or {})
        self._sharded = bool(sharded)
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
        Transport(collective_transport)  # validates the name
        on_cuda = check_device(device).type == "cuda"
        resources = dict(resources_per_worker or (
            {"GPU": 1} if on_cuda else {"CPU": 1}))
        gpus = resources.get("GPU", 0)
        if on_cuda and gpus <= 0:
            raise ValueError(
                "a worker on CUDA needs resources_per_worker {'GPU': 1}")
        nodes = ray_tpu_torch.nodes()
        node_gpus = max((n["Resources"].get("GPU", 0) for n in nodes),
                        default=0)
        if gpus > node_gpus:
            raise ValueError(
                f"resources_per_worker asks for {gpus} GPU(s); no node of "
                f"the cluster has more than {node_gpus}")
        if gpus and num_workers * gpus > node_gpus:
            if len(nodes) > 1:
                raise NotImplementedError(
                    f"{num_workers} ranks of {gpus} GPU(s) need more than "
                    "one node; ranks across nodes are ROADMAP.md A4 item 5")
            # more ranks than cards on the node: k ranks share a card
            resources["GPU"] = 1 / math.ceil(num_workers * gpus / node_gpus)
        self._num_workers = num_workers
        self._last_state: dict | None = None
        self._last_shards: list | None = None
        group_name = (f"trainer_{os.getpid()}_{next(_GROUP_IDS)}"
                      if num_workers > 1 else None)
        # cloudpickle: operator classes defined in __main__ serialize by
        # value (stdlib pickle would import them by reference and fail on
        # the worker)
        pickled = cloudpickle.dumps(training_operator_cls)
        worker_cls = ray_tpu_torch.remote(resources=resources)(TrainWorker)
        self.workers = [worker_cls.remote(
            pickled, self._config, rank, num_workers, group_name,
            None if on_cuda else "cpu", resources.get("CPU", 1))
            for rank in range(num_workers)]
        self._pids: list[int] = []
        try:
            if group_name is not None:
                col.create_collective_group(
                    self.workers, num_workers, list(range(num_workers)),
                    backend="host", group_name=group_name,
                    timeout=collective_timeout, quantize=quantize,
                    transport=collective_transport)
            self._pids = ray_tpu_torch.get(
                [w.setup_operator.remote() for w in self.workers],
                timeout=setup_timeout)
        except BaseException:
            self.shutdown()
            raise

    def train(self, num_steps: int | None = None,
              reduce_results: bool = True, profile_dir: str | None = None):
        """One epoch of every rank; the mean of their results (sums of
        counts and throughput). Rank 0's state_dict comes back after it,
        as in the reference."""
        kw = {"profile_dir": profile_dir} if profile_dir else {}
        results = self._gather("train_epoch", num_steps, **kw)
        self._last_state = self.state_dict()
        if self._sharded:
            self._last_state.pop("opt_shard", None)
            self._last_shards = ray_tpu_torch.get(
                [w.opt_shard_state.remote() for w in self.workers],
                timeout=120)
        return _reduce(results) if reduce_results else results

    def validate(self, num_steps: int | None = None,
                 reduce_results: bool = True):
        results = self._gather("validate", num_steps)
        return _reduce(results) if reduce_results else results

    def _gather(self, method: str, *args, **kw) -> list[dict]:
        """Every rank's result of a worker method, in rank order."""
        return ray_tpu_torch.get(
            [getattr(w, method).remote(*args, **kw) for w in self.workers],
            timeout=600)

    def state_dict(self) -> dict:
        return ray_tpu_torch.get(self.workers[0].state_dict.remote(),
                                 timeout=120)

    def load_state_dict(self, state: dict):
        self._last_state = state
        ray_tpu_torch.get([w.load_state_dict.remote(state)
                           for w in self.workers], timeout=120)

    @property
    def num_workers(self) -> int:
        return self._num_workers

    def shutdown(self, timeout: float = 60.0):
        """Ends the workers and waits until their processes are gone, so
        the cards they held are free when this returns."""
        for w in self.workers:
            w.shutdown.remote()
        if not self._pids or not _wait_gone(self._pids, timeout):
            # a worker whose set-up failed (its pid unknown), or one that
            # does not end
            for w in self.workers:
                ray_tpu_torch.kill(w)
            if not _wait_gone(self._pids, timeout):
                raise TimeoutError(
                    f"worker processes {self._pids} outlived shutdown")
        self.workers = []
        self._pids = []


def _wait_gone(pids: list[int], timeout: float) -> bool:
    """Waits until no pid is a live process (a zombie has already freed
    its memory); False at the timeout."""
    deadline = time.monotonic() + timeout
    while True:
        live = []
        for pid in pids:
            try:
                with open(f"/proc/{pid}/stat") as f:
                    state = f.read().rsplit(")", 1)[1].split()[0]
            except OSError:
                continue
            if state != "Z":
                live.append(pid)
        if not live:
            return True
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)


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
