"""Trainable — the unit of execution Tune schedules (reference:
python/ray/tune/trainable.py:32 — setup/step/save_checkpoint/
load_checkpoint lifecycle; function API wrapper: function_runner.py).
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time


class Trainable:
    """Class API: subclass, implement setup/step/save_checkpoint/
    load_checkpoint. One instance per trial, living in an actor."""

    def __init__(self, config: dict | None = None):
        self.config = config or {}
        self._iteration = 0
        self._time_total = 0.0
        self.setup(self.config)

    # -- user surface ---------------------------------------------------

    def setup(self, config: dict):
        pass

    def step(self) -> dict:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> str | dict | None:
        return None

    def load_checkpoint(self, checkpoint) -> None:
        pass

    def cleanup(self):
        pass

    def reset_config(self, new_config: dict) -> bool:
        """Reuse this instance for a new config (PBT exploit without actor
        restart). Return True if handled."""
        return False

    # -- framework surface ----------------------------------------------

    @property
    def iteration(self) -> int:
        return self._iteration

    def train(self) -> dict:
        t0 = time.perf_counter()
        result = self.step() or {}
        self._iteration += 1
        self._time_total += time.perf_counter() - t0
        result.setdefault("training_iteration", self._iteration)
        result.setdefault("time_total_s", self._time_total)
        result.setdefault("done", False)
        return result

    def save(self, checkpoint_dir: str | None = None) -> bytes:
        """Serialize a checkpoint to bytes (the object plane carries it;
        reference saves to disk + syncer — here checkpoints are plain
        values so multi-node restore needs no shared filesystem)."""
        own_tmp = checkpoint_dir is None
        tmp = checkpoint_dir or tempfile.mkdtemp(prefix="tune_ckpt_")
        try:
            data = self.save_checkpoint(tmp)
            if isinstance(data, str):
                # user wrote files under tmp and returned the path
                payload = {}
                base = data if os.path.isdir(data) else os.path.dirname(data)
                for root, _, files in os.walk(base):
                    for f in files:
                        p = os.path.join(root, f)
                        with open(p, "rb") as fh:
                            payload[os.path.relpath(p, base)] = fh.read()
                blob = {"kind": "dir", "files": payload}
            else:
                blob = {"kind": "obj", "data": data}
        finally:
            if own_tmp:
                shutil.rmtree(tmp, ignore_errors=True)
        # Framework counters ride along so a resumed trial keeps its
        # training_iteration (schedulers key rungs/intervals off it).
        blob["iteration"] = self._iteration
        blob["time_total"] = self._time_total
        return pickle.dumps(blob)

    def restore(self, blob: bytes):
        state = pickle.loads(blob)
        self._iteration = state.get("iteration", self._iteration)
        self._time_total = state.get("time_total", self._time_total)
        if state["kind"] == "dir":
            tmp = tempfile.mkdtemp(prefix="tune_restore_")
            try:
                for rel, content in state["files"].items():
                    p = os.path.join(tmp, rel)
                    os.makedirs(os.path.dirname(p), exist_ok=True)
                    with open(p, "wb") as fh:
                        fh.write(content)
                self.load_checkpoint(tmp)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        else:
            self.load_checkpoint(state["data"])

    def stop(self):
        self.cleanup()


class FunctionTrainable(Trainable):
    """Wraps `def train_fn(config)` generators / tune.report style functions
    (reference: function_runner.py). The function either:
      - yields result dicts (preferred, resumable step-by-step), or
      - calls tune.report(**metrics) (run to completion on first step).
    """

    _fn = None  # set by make_function_trainable

    def setup(self, config):
        self._gen = None
        self._last: dict = {}
        self._done = False

    def _ensure_gen(self):
        if self._gen is None:
            import inspect

            out = type(self)._fn(self.config)
            if inspect.isgenerator(out):
                self._gen = out
            else:
                # plain function: ran to completion; collect reports
                self._gen = iter(_reported_results())
                self._done = True

    def step(self):
        self._ensure_gen()
        try:
            self._last = dict(next(self._gen))
            return dict(self._last)
        except StopIteration:
            # keep the final metrics visible on the terminating result
            return {**self._last, "done": True}


_REPORT_BUFFER: list[dict] = []


def report(**metrics):
    """tune.report for plain-function trainables."""
    _REPORT_BUFFER.append(dict(metrics))


def _reported_results():
    out, _REPORT_BUFFER[:] = list(_REPORT_BUFFER), []
    return out


def make_function_trainable(fn) -> type:
    return type(f"func_{getattr(fn, '__name__', 'trainable')}",
                (FunctionTrainable,), {"_fn": staticmethod(fn)})
