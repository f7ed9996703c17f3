"""Trainer and TrainWorker; port of ray_tpu/train/trainer.py (reference:
python/ray/util/sgd/torch/torch_trainer.py: train :365, the fault-tolerant
_resize_worker_group :328, save/load :543/:552).

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
`state_dict`, `load_state_dict`, `save`, `load`, `shutdown`, and
`_reduce` over the ranks' results.

Fault tolerance, as the reference's: the workers are one generation,
gang-reserved through a placement group (`placement_strategy`; best
effort), whose collective group is named after the generation. A
`train` or `validate` that loses a rank (a dead worker, or a survivor's
collective timing out on it) kills the generation, waits until its
processes are gone and their leases returned, starts the next at
whatever size the node can hold now, and restores the state of the last
completed `train()`: the parameters broadcast once over the group's data
plane (`TrainWorker.sync_state`) and, under `sharded=True`, the ranks'
optimizer shards resharded to the new world size; then the call runs
again, at most `max_retries` times. An error with every rank alive is
the user's and is raised at once.

`config={"multihost": True}`: the generation's ranks join one multihost
runtime (parallel/multihost.initialize: their default process group,
NCCL a card a rank or gloo on the CPU) before the operator is built, and
have no collective group: the operator steps SPMD over a mesh of that
runtime (`register(mesh=)`, or `mesh_mode="fsdp"`). Its state_dict is
then a collective that every rank calls. A re-gang joins the next
generation's runtime.

`ingest=IngestSpec(...)`: one DatasetShard actor a rank streams the
rank's batches through the object store (train/ingest.py); the actors
belong to the generation, counted in its gang scan, killed with it and
restarted at the new world size.
"""

from __future__ import annotations

import importlib
import math
import os
import pickle
import time
import uuid

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import global_state
from ray_tpu_torch._private.common import quantize as _quantized
from ray_tpu_torch._private.device import check_device, resolve_device
from ray_tpu_torch.collective import collective as col
from ray_tpu_torch.collective.types import Transport, normalize_quantize

# Sharded checkpoint manifest marker (Trainer.save/load): `path` holds a
# small index dict with this format tag; the parameters and the ranks'
# optimizer shards live in sibling files it names.
_SHARDED_CKPT_FORMAT = "ray_tpu.sharded_ckpt"

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

    def setup_operator(self, timeout: float = 60.0) -> int:
        """Builds the rank (after the group, when there is one); returns
        the worker's pid, which Trainer.shutdown waits on. A CPU worker
        computes on the CPUs it leased: torch's threads are that many, so
        its float sums keep one order whatever else runs on the host.
        Under config["multihost"] the process first joins the generation's
        multihost runtime (reference: trainer.py:46-53), waiting `timeout`
        seconds for its peers there and in each collective."""
        if self._device == "cpu":
            import torch

            torch.set_num_threads(max(1, int(self._num_cpus)))
        if self._config.get("multihost"):
            from ray_tpu_torch.parallel import multihost

            multihost.initialize(
                self._group_name, self._world_size, self._rank,
                backend="gloo" if self._device == "cpu" else "nccl",
                timeout=timeout)
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

    def state_dict(self, keep: bool = True):
        """The rank's state_dict; None unless `keep` (on a mesh every rank
        takes part in the gather, and one copy comes back)."""
        state = self.operator.state_dict()
        return state if keep else None

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

    def attach_ingest(self, dataset_actor, depth: int):
        """Feeds the rank from its DatasetShard actor: batches prefetch
        `depth` deep through the object store while the step computes (the
        validation loader stays)."""
        from ray_tpu_torch.train.ingest import IngestStream

        op = self.operator
        op.register_data(
            train_loader=IngestStream(dataset_actor, depth,
                                      lambda: op.epoch),
            validation_loader=op._val_loader)
        return True

    def run(self, fn):
        """fn([operator]), this worker's rank's TrainingOperator in a
        list, run in this worker's process: for checks and tools that
        must see a rank's model or its process state (device memory,
        counters)."""
        return fn([self.operator])

    def sync_state(self, src_rank: int = 0):
        """Broadcasts the whole training state from src_rank over the
        group's data plane (the host tiers: shm on one node), instead of
        the driver pushing a pickled copy to every rank. Every rank calls
        it; returns the bytes broadcast."""
        import numpy as np

        group = col.get_group(self._group_name)
        if self._rank == src_rank:
            blob = np.frombuffer(
                pickle.dumps(self.operator.state_dict()), np.uint8)
            size = np.array([blob.size], np.int64)
        else:
            blob = None
            size = np.zeros(1, np.int64)
        size = group.broadcast(size, src_rank)  # geometry first: every
        if self._rank != src_rank:              # rank passes one shape
            blob = np.empty(int(size[0]), np.uint8)
        out = group.broadcast(blob, src_rank)
        if self._rank != src_rank:
            self.operator.load_state_dict(pickle.loads(out.tobytes()))
        return int(size[0])

    def shutdown(self):
        """Frees the group and ends the process (its card memory goes
        with it)."""
        if self._group_name is not None and col.is_group_initialized(
                self._group_name):
            col.destroy_collective_group(self._group_name)
        if self._config.get("multihost"):
            from ray_tpu_torch.parallel import multihost

            multihost.shutdown()
        self.operator = None
        ray_tpu_torch.exit_actor()


class Trainer:
    """Data-parallel trainer with elastic fault tolerance (reference:
    torch_trainer.py:39).

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
    the rank's 1/N flat span, allgather(params); checkpoints become
    per-rank shard files behind an index manifest (save/load), and a
    resize re-partitions the optimizer shards to the new world size.
    mesh_mode="fsdp": the operator builds the ('data','fsdp') mesh
    (parallel.mesh.fsdp_mesh) and shards the parameters over fsdp; one
    worker, or several under config={"multihost": True}. A multihost
    trainer on CUDA needs a card a rank (NCCL refuses two ranks on one
    card). ingest: an ingest.IngestSpec, one DatasetShard actor a rank
    streaming its batches; it replaces the operator's train_loader.

    max_retries: re-gangs a `train`/`validate` call may take after losing
    a rank. placement_strategy (default "ICI_RING", which places as PACK
    here: no TPU topology): each generation's workers are gang-reserved
    through a placement group; a reservation not ready within 3 s is
    dropped and the workers schedule as without one. None turns the
    reservation off."""

    def __init__(self, training_operator_cls, *, num_workers: int = 1,
                 config: dict | None = None,
                 resources_per_worker: dict | None = None,
                 max_retries: int = 3,
                 collective_timeout: float = 30.0,
                 setup_timeout: float = 600.0,
                 quantize: str | None = None,
                 collective_transport: str = "auto",
                 placement_strategy: str | None = "ICI_RING",
                 sharded: bool = False, mesh_mode: str | None = None,
                 ingest=None, device=None):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self._operator_cls = training_operator_cls
        self._config = dict(config or {})
        self._multihost = bool(self._config.get("multihost"))
        self._sharded = bool(sharded)
        if sharded:
            if mesh_mode is not None:
                raise ValueError(
                    "sharded=True (collective ZeRO) and mesh_mode (SPMD) "
                    "are mutually exclusive update plans")
            if self._multihost:
                raise ValueError(
                    "sharded=True uses the HOST collective plane; "
                    "multihost groups sync through the mesh's collectives "
                    "instead")
            self._config["sharded_update"] = True
        if mesh_mode is not None:
            if mesh_mode != "fsdp":
                raise ValueError(f"unknown mesh_mode {mesh_mode!r} "
                                 "(expected 'fsdp' or None)")
            if num_workers > 1 and not self._multihost:
                raise ValueError(
                    "mesh_mode='fsdp' with multiple workers requires "
                    "config={'multihost': True} (a GLOBAL mesh); "
                    "host-backend workers would each build a private "
                    "mesh and never sync")
            self._config["mesh_mode"] = mesh_mode
        self._ingest = ingest
        self._ingest_actors: list = []
        self._ingest_pids: list[int] = []
        self._quantize = normalize_quantize(quantize)
        Transport(collective_transport)  # validates the name
        self._collective_transport = collective_transport
        self._on_cuda = check_device(device).type == "cuda"
        resources = dict(resources_per_worker or (
            {"GPU": 1} if self._on_cuda else {"CPU": 1}))
        gpus = resources.get("GPU", 0)
        if self._on_cuda and gpus <= 0:
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
            if self._multihost:
                raise ValueError(
                    f"a multihost trainer of {num_workers} ranks on "
                    f"{node_gpus} card(s) would put two ranks on one card; "
                    "NCCL refuses that, so a multihost trainer on CUDA needs "
                    "a card a rank")
        self._resources = resources
        self._num_workers = num_workers
        self._max_retries = max_retries
        self._collective_timeout = collective_timeout
        self._setup_timeout = setup_timeout
        self._placement_strategy = placement_strategy
        self._pg = None
        self._generation = 0
        self._uid = uuid.uuid4().hex[:8]
        self._group_name: str | None = None
        self.workers: list = []
        self._pids: list[int] = []
        self._last_state: dict | None = None
        self._last_shards: list | None = None
        # one record per re-gang (read by chip_smoke.py): the driver's
        # monotonic clock when the failure reached it, when the old
        # generation's teardown began, when the next one's start began
        # and when it was restored; the seconds of the restore and of its
        # sync_state round
        self._regangs: list[dict] = []
        self._last_start: dict = {}
        try:
            self._start_workers(num_workers)
        except BaseException:
            self._kill_workers()
            raise

    # ------------------------------------------------------------------
    # worker group lifecycle (reference: worker_group.py:107/:208)
    # ------------------------------------------------------------------

    def _gang_reserve(self, num_workers: int):
        """One bundle a worker under the trainer's placement strategy.
        Best effort: a reservation that is not ready within 3 s (the
        previous generation's resources still draining, a saturated
        node) is removed and the workers schedule as without one."""
        if self._placement_strategy is None or num_workers <= 1:
            return None
        from ray_tpu_torch.util.placement_group import (
            placement_group, remove_placement_group)

        try:
            pg = placement_group(
                [dict(self._resources) for _ in range(num_workers)],
                strategy=self._placement_strategy,
                name=f"sgd-{self._uid}-g{self._generation}")
        except Exception:
            return None
        try:
            if pg.ready(timeout=3.0):
                return pg
        except Exception:
            pass
        # not placeable: the registered group must not linger (a later
        # retry in the GCS would reserve a worker set nobody uses)
        try:
            remove_placement_group(pg)
        except Exception:
            pass
        return None

    def _release_gang(self):
        if self._pg is None:
            return
        from ray_tpu_torch.util.placement_group import remove_placement_group

        try:
            remove_placement_group(self._pg)
        except Exception:
            pass
        self._pg = None

    def _start_workers(self, num_workers: int):
        started_at = time.monotonic()
        self._generation += 1
        self._group_name = group_name = f"sgd_{self._uid}_g{self._generation}"
        # cloudpickle: operator classes defined in __main__ serialize by
        # value (stdlib pickle would import them by reference and fail on
        # the worker)
        pickled = cloudpickle.dumps(self._operator_cls)
        self._pg = self._gang_reserve(num_workers)
        worker_cls = ray_tpu_torch.remote(
            resources=dict(self._resources))(TrainWorker)
        args = (pickled, self._config)
        tail = (num_workers, group_name, None if self._on_cuda else "cpu",
                self._resources.get("CPU", 1))
        self.workers = [
            worker_cls.options(
                placement_group=self._pg,
                placement_group_bundle_index=rank,
            ).remote(*args, rank, *tail)
            if self._pg is not None else worker_cls.remote(*args, rank, *tail)
            for rank in range(num_workers)]
        self._pids = []
        if num_workers > 1 and not self._multihost:
            # a multihost generation syncs through its mesh's collectives:
            # no HOST group (reference: trainer.py:313-314)
            col.create_collective_group(
                self.workers, num_workers, list(range(num_workers)),
                backend="host", group_name=group_name,
                timeout=self._collective_timeout, quantize=self._quantize,
                transport=self._collective_transport,
                placement_group=self._pg)
        self._pids = ray_tpu_torch.get(
            [w.setup_operator.remote(max(60.0, self._collective_timeout))
             for w in self.workers], timeout=self._setup_timeout)
        self._start_ingest(num_workers)
        self._last_start = {"started_at": started_at,
                            **self._restore_state()}

    def _start_ingest(self, num_workers: int):
        """One DatasetShard actor a rank; every generation re-shards the
        dataset over its own world size (reference: trainer.py:332-353)."""
        if self._ingest is None:
            return
        from ray_tpu_torch._private.config import get_config
        from ray_tpu_torch.train.ingest import DatasetShard

        spec = self._ingest
        depth = (spec.prefetch_depth if spec.prefetch_depth is not None
                 else get_config().train_ingest_prefetch_depth)
        shard_cls = ray_tpu_torch.remote(
            resources=dict(spec.resources or {"CPU": 1}))(DatasetShard)
        fn_pickled = cloudpickle.dumps(spec.dataset_fn)
        self._ingest_actors = [
            shard_cls.remote(fn_pickled, rank, num_workers, self._config)
            for rank in range(num_workers)]
        self._ingest_pids = ray_tpu_torch.get(
            [a.ping.remote() for a in self._ingest_actors],
            timeout=self._setup_timeout)
        ray_tpu_torch.get([w.attach_ingest.remote(a, depth)
                           for w, a in zip(self.workers,
                                           self._ingest_actors)],
                          timeout=self._setup_timeout)

    def _restore_state(self) -> dict:
        """Re-installs the training state into a fresh generation: the
        parameters and progress broadcast once over the data plane, then
        (sharded) each rank's optimizer shard, resharded to the new world
        size where it changed. Returns its seconds, and sync_state's."""
        num_workers = len(self.workers)
        t0 = time.perf_counter()
        sync_s = None
        if self._last_state is not None:
            if num_workers > 1 and not self._multihost:
                # the driver sends ONE copy, to rank 0; the group's data
                # plane fans it out
                ray_tpu_torch.get(
                    self.workers[0].load_state_dict.remote(self._last_state),
                    timeout=self._setup_timeout)
                t1 = time.perf_counter()
                ray_tpu_torch.get([w.sync_state.remote(0)
                                   for w in self.workers],
                                  timeout=self._setup_timeout)
                sync_s = time.perf_counter() - t1
            else:
                ray_tpu_torch.get([w.load_state_dict.remote(self._last_state)
                                   for w in self.workers],
                                  timeout=self._setup_timeout)
        if self._sharded and self._last_shards:
            shards = self._last_shards
            if len(shards) != num_workers:
                from ray_tpu_torch.train import sharding as _shardlib

                shards = _shardlib.reshard_opt_shards(shards, num_workers)
            ray_tpu_torch.get([w.load_opt_shard.remote(s)
                               for w, s in zip(self.workers, shards)],
                              timeout=self._setup_timeout)
        return {"restore_s": time.perf_counter() - t0,
                "sync_state_s": sync_s}

    def _kill_workers(self, timeout: float = 60.0):
        """Kills the generation and waits until its processes are gone and
        the raylet has returned their leases (so the next generation sees
        every resource they held, and the cards' memory is free), its
        ingest actors' too; then releases the gang's bundles."""
        for w in self.workers + self._ingest_actors:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        pids = self._pids + self._ingest_pids
        self.workers, self._pids = [], []
        self._ingest_actors, self._ingest_pids = [], []
        try:
            if not _wait_gone(pids, timeout):
                raise TimeoutError(
                    f"worker processes {pids} outlived their kill")
        finally:
            # release the bundles BEFORE the next generation reserves its
            # own: a lingering hold would starve the new reservation
            self._release_gang()

    def _resize_worker_group(self):
        """Reference: torch_trainer.py:328. Shuts the group down, restarts
        it at whatever size is schedulable now, restores the state."""
        broken, _ = self._gang_interrupted()
        if not broken and len(self.workers) == self._num_workers:
            # no-op: the gang is intact at full strength; restarting would
            # pay a state broadcast for nothing
            return
        self._kill_workers()
        # prefer the full size; shrink to what every resource can hold,
        # counted in the resource set's quantized units (k ranks sharing
        # a card each hold 1/k of it, which floats do not divide exactly)
        target = self._num_workers
        avail = ray_tpu_torch.available_resources()
        for res, need in self._resources.items():
            if need > 0:
                target = min(target, _quantized(avail.get(res, 0))
                             // _quantized(need))
        try:
            self._start_workers(max(1, target))
        except Exception:
            self._kill_workers()
            raise

    # ------------------------------------------------------------------
    # train/validate (reference: torch_trainer.py:365 train)
    # ------------------------------------------------------------------

    def _any_worker_dead(self) -> bool:
        return self._gang_interrupted()[0]

    def _gang_interrupted(self) -> tuple[bool, bool]:
        """-> (broken, planned). Broken: a worker or an ingest actor is DEAD
        (a dead DatasetShard means its rank's stream is gone, so the
        generation restarts as for a dead worker). Planned: every death
        found was a drain. The port has no drain, so `planned` never holds
        here; the branch keeps the reference's shape."""
        cw = global_state.require_core_worker()
        broken, planned = False, True
        for w in self.workers + self._ingest_actors:
            info = cw.get_actor_info(w._actor_id.binary())
            if info is None or info.get("state") == "DEAD":
                broken = True
                if "drained" not in (info or {}).get("death_cause", ""):
                    planned = False
        return broken, broken and planned

    # planned departures re-gang for free, but boundedly so
    _MAX_PLANNED_REGANGS = 8

    def _run_with_retries(self, fn_name: str, num_steps, **kw):
        attempt = 0
        planned_regangs = 0
        while True:
            try:
                if not self.workers:
                    raise exc.WorkerCrashedError("worker group is empty")
                return _gather(
                    [getattr(w, fn_name).remote(num_steps, **kw)
                     for w in self.workers], timeout=600)
            except (exc.ActorDiedError, exc.WorkerCrashedError,
                    exc.GetTimeoutError):
                failed_at = time.monotonic()
                _, planned = self._gang_interrupted()
                if planned and planned_regangs < self._MAX_PLANNED_REGANGS:
                    planned_regangs += 1
                elif attempt >= self._max_retries:
                    raise
                else:
                    attempt += 1
            except exc.TaskError:
                # a collective timing out in a surviving rank means a peer
                # died mid-call; with every rank alive it is the user's
                failed_at = time.monotonic()
                broken, planned = self._gang_interrupted()
                if not broken:
                    raise
                if planned and planned_regangs < self._MAX_PLANNED_REGANGS:
                    planned_regangs += 1
                elif attempt >= self._max_retries:
                    raise
                else:
                    attempt += 1
            time.sleep(0.5)
            try:
                resize_at = time.monotonic()
                self._resize_worker_group()
                self._regangs.append({
                    "generation": self._generation, "failed_at": failed_at,
                    "resize_at": resize_at, "restored_at": time.monotonic(),
                    "world_size": len(self.workers), **self._last_start})
            except Exception:
                if attempt >= self._max_retries:
                    raise
                # the group is left empty; the next attempt resizes again

    def train(self, num_steps: int | None = None,
              reduce_results: bool = True, profile_dir: str | None = None):
        """One epoch of every rank; the mean of their results (sums of
        counts and throughput). Rank 0's state_dict (and, sharded, every
        rank's optimizer shard) comes back after it: the snapshot a
        re-gang restores."""
        kw = {"profile_dir": profile_dir} if profile_dir else {}
        results = self._run_with_retries("train_epoch", num_steps, **kw)
        self._last_state = self.state_dict()
        if self._sharded:
            self._last_state.pop("opt_shard", None)
            self._last_shards = ray_tpu_torch.get(
                [w.opt_shard_state.remote() for w in self.workers],
                timeout=120)
        return _reduce(results) if reduce_results else results

    def validate(self, num_steps: int | None = None,
                 reduce_results: bool = True):
        results = self._run_with_retries("validate", num_steps)
        return _reduce(results) if reduce_results else results

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def state_dict(self) -> dict:
        """Rank 0's state_dict. Under multihost it is a collective (the
        mesh's shards gathered), so every rank computes it and rank 0's
        comes back."""
        if not self._multihost:
            return ray_tpu_torch.get(self.workers[0].state_dict.remote(),
                                     timeout=120)
        return ray_tpu_torch.get(
            [w.state_dict.remote(r == 0) for r, w in enumerate(self.workers)],
            timeout=120)[0]

    def load_state_dict(self, state: dict):
        self._last_state = state
        ray_tpu_torch.get([w.load_state_dict.remote(state)
                           for w in self.workers], timeout=120)

    def save(self, path: str) -> str:
        """Unsharded: one pickle. Sharded: each rank's optimizer shard
        comes back through the object store and the driver writes one
        file a shard, the parameters, and a small index manifest at
        `path`; no replicated optimizer state is assembled anywhere."""
        if not self._sharded:
            with open(path, "wb") as f:
                pickle.dump(self.state_dict(), f)
            return path
        state = self.state_dict()
        state.pop("opt_shard", None)
        shard_refs = [w.opt_shard_state.remote() for w in self.workers]
        params_file = os.path.basename(path) + ".params"
        with open(path + ".params", "wb") as f:
            pickle.dump(state, f)
        spans, shard_files = [], []
        for i, ref in enumerate(shard_refs):
            sh = ray_tpu_torch.get(ref, timeout=120)
            spans.append(tuple(sh["span"]))
            shard_files.append(os.path.basename(path) + f".shard{i}")
            with open(f"{path}.shard{i}", "wb") as f:
                pickle.dump(sh, f)
            numel, pad_numel = sh["numel"], sh["pad_numel"]
        manifest = {
            "format": _SHARDED_CKPT_FORMAT, "version": 1,
            "world_size": len(shard_files),
            "numel": numel, "pad_numel": pad_numel, "spans": spans,
            "epoch": state["epoch"], "global_step": state["global_step"],
            "params_file": params_file, "shard_files": shard_files,
        }
        with open(path, "wb") as f:
            pickle.dump(manifest, f)
        return path

    def load(self, path: str):
        """Loads either format; a sharded manifest reshards to the
        CURRENT world size on the way in (any saved N to any running N)."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if not (isinstance(blob, dict)
                and blob.get("format") == _SHARDED_CKPT_FORMAT):
            self.load_state_dict(blob)
            return
        if not self._sharded:
            raise ValueError(
                f"{path} is a sharded checkpoint manifest; load it with "
                "Trainer(sharded=True)")
        base = os.path.dirname(os.path.abspath(path))
        with open(os.path.join(base, blob["params_file"]), "rb") as f:
            self._last_state = pickle.load(f)
        self._last_shards = []
        for sf in blob["shard_files"]:
            with open(os.path.join(base, sf), "rb") as f:
                self._last_shards.append(pickle.load(f))
        self._restore_state()

    @property
    def num_workers(self) -> int:
        return len(self.workers)

    def shutdown(self, force: bool = False, timeout: float = 60.0):
        """Ends the workers and waits until their processes are gone, so
        the cards they held are free when this returns; then releases the
        gang. force=True kills them at once."""
        if not force:
            for w in self.workers:
                try:
                    w.shutdown.remote()
                except Exception:
                    pass
            if self._pids and _wait_gone(self._pids, timeout):
                self.workers, self._pids = [], []
        # a worker whose set-up failed (its pid unknown), one that does
        # not end, or force
        self._kill_workers(timeout)


def _gather(refs: list, timeout: float) -> list:
    """Every result, in order; the first failure raised as soon as it is
    known (a dead rank's ActorDiedError at once, while its peers still
    wait in a collective for it)."""
    deadline = time.monotonic() + timeout
    pending = list(refs)
    while pending:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise exc.GetTimeoutError(
                f"{len(pending)} of {len(refs)} ranks did not answer "
                f"within {timeout} s")
        ready, pending = ray_tpu_torch.wait(pending, num_returns=1,
                                            timeout=remaining)
        ray_tpu_torch.get(ready)  # raises the rank's failure
    return ray_tpu_torch.get(refs)


def _wait_gone(pids: list[int], timeout: float) -> bool:
    """Waits until no pid is a live process (a zombie has already freed
    its memory) nor a worker the raylet still holds (it returns a
    worker's lease as it drops the worker); False at the timeout."""
    if not pids:
        return True
    cw = global_state.require_core_worker()
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
            held = set(cw.cluster_info()["worker_pids"])
            if not held.intersection(pids):
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
