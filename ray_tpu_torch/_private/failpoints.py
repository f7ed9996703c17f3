"""Deterministic fault injection: named failpoints at the runtime's seams;
port of ray_tpu/_private/failpoints.py, process-local.

A failpoint is `name = action(predicates)`:

    actions      raise      raise FailpointError at the seam
                 delay      sleep `ms` milliseconds (async-safe at async seams)
                 drop_conn  returned to the site, which drops its connection
                            (a seam with none raises instead: fire_strict)
                 exit       hard process kill (os._exit) — SIGKILL-equivalent
                 off        disarmed (catalog entry only)
    predicates   p=F        fire with probability F per hit (seeded RNG)
                 nth=N      fire only on exactly the Nth hit of this point
                 once       disarm after the first firing
                 ms=F       delay duration (action=delay)
                 role=R     only fire in processes whose role is R
                            (driver|worker|raylet|gcs)

Points are armed in one process: `arm()`/`configure()`, or the
`RAY_TPU_TORCH_FAILPOINTS` environment variable at import (inherited by
every process the runtime spawns), e.g.
``RAY_TPU_TORCH_FAILPOINTS="serve.decode_step=delay(ms=50)"``. The
reference's cluster-wide arming through the internal KV and pubsub
(`arm_cluster`) is not ported yet.

Randomness is seeded from `RAY_TPU_TORCH_CHAOS_SEED` (mixed with the
process role). Sites guard with the module-level `ARMED` flag so an
unarmed registry costs one attribute load on the hot paths:

    from ray_tpu_torch._private import failpoints as _fp
    ...
    if _fp.ARMED:
        _fp.fire_strict("serve.decode_step")
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import threading
import time

logger = logging.getLogger("ray_tpu_torch.failpoints")

ENV_VAR = "RAY_TPU_TORCH_FAILPOINTS"
SEED_ENV = "RAY_TPU_TORCH_CHAOS_SEED"
EXIT_CODE = 113  # distinctive rc: "this process was killed by a failpoint"

ACTIONS = ("raise", "delay", "drop_conn", "exit", "off")
ROLES = ("driver", "worker", "raylet", "gcs")

# True iff any point is armed — the one-word fast guard every site checks.
ARMED = False


class FailpointError(RuntimeError):
    """Raised at a seam by an armed `raise` action."""

    def __init__(self, name: str):
        self.failpoint = name
        super().__init__(f"injected failure at failpoint {name!r}")


@dataclasses.dataclass
class Failpoint:
    name: str
    action: str
    p: float = 1.0
    nth: int = 0          # 0 = every hit; N>0 = only the Nth hit
    once: bool = False
    ms: float = 0.0       # delay duration
    role: str = ""        # "" = every process role
    hits: int = 0         # times the site was reached (post role filter)
    fired: int = 0        # times the action actually applied

    def spec_text(self) -> str:
        args = []
        if self.p != 1.0:
            args.append(f"p={self.p:g}")
        if self.nth:
            args.append(f"nth={self.nth}")
        if self.once:
            args.append("once")
        if self.ms:
            args.append(f"ms={self.ms:g}")
        if self.role:
            args.append(f"role={self.role}")
        return (f"{self.name}={self.action}({','.join(args)})" if args
                else f"{self.name}={self.action}")


_lock = threading.Lock()
_registry: dict[str, Failpoint] = {}
_role = os.environ.get("RAY_TPU_TORCH_PROCESS_ROLE", "")
_seed = os.environ.get(SEED_ENV)
_rng = random.Random()


def _reseed():
    """Deterministic when RAY_TPU_TORCH_CHAOS_SEED is set: mixed with the
    role so co-located processes make different (but replayable)
    draws."""
    if _seed is not None:
        _rng.seed(f"{_seed}:{_role}")


_reseed()


def set_role(role: str, only_if_unset: bool = False) -> None:
    """Declare this process's role (driver|worker|raylet|gcs) for the
    `role=` predicate. Called once at process bootstrap."""
    global _role
    if only_if_unset and _role:
        return
    _role = role
    _reseed()


def get_role() -> str:
    return _role


def _parse_one(text: str) -> Failpoint:
    name, sep, rhs = text.partition("=")
    name = name.strip()
    if not sep or not name:
        raise ValueError(f"malformed failpoint spec {text!r} "
                         f"(expected 'name=action(args)')")
    rhs = rhs.strip()
    action, _, argstr = rhs.partition("(")
    action = action.strip()
    if action not in ACTIONS:
        raise ValueError(f"unknown failpoint action {action!r} in {text!r} "
                         f"(expected one of {ACTIONS})")
    fp = Failpoint(name=name, action=action)
    argstr = argstr.rstrip(")").strip()
    if argstr:
        for part in argstr.split(","):
            part = part.strip()
            if not part:
                continue
            k, ksep, v = part.partition("=")
            k = k.strip()
            v = v.strip()
            if k == "once" and not ksep:
                fp.once = True
            elif k == "p":
                fp.p = float(v)
            elif k == "nth":
                fp.nth = int(v)
            elif k == "once":
                fp.once = v.lower() not in ("0", "false", "")
            elif k == "ms":
                fp.ms = float(v)
            elif k == "role":
                fp.role = v
            else:
                raise ValueError(
                    f"unknown failpoint predicate {k!r} in {text!r}")
    return fp


def parse(text: str) -> dict[str, Failpoint]:
    """Parse a config string: ';'-separated `name=action(args)` entries."""
    out: dict[str, Failpoint] = {}
    for chunk in (text or "").split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        fp = _parse_one(chunk)
        out[fp.name] = fp
    return out


def _recompute_armed():
    global ARMED
    ARMED = any(fp.action != "off" for fp in _registry.values())


def configure(text: str, replace: bool = True) -> None:
    """(Re)arm the registry from a config string. `replace=True` makes the string the complete new registry, so
    an empty string disarms everything."""
    specs = parse(text)
    with _lock:
        if replace:
            _registry.clear()
        _registry.update(specs)
        _recompute_armed()
    if specs:
        logger.info("failpoints configured (%s): %s", _role or "?",
                    "; ".join(fp.spec_text() for fp in specs.values()))


def arm(name: str, action: str, **kw) -> None:
    """Arm one point programmatically (local process only)."""
    if action not in ACTIONS:
        raise ValueError(f"unknown failpoint action {action!r}")
    with _lock:
        _registry[name] = Failpoint(name=name, action=action, **kw)
        _recompute_armed()


def reset() -> None:
    """Disarm everything and clear counters (test isolation)."""
    with _lock:
        _registry.clear()
        _recompute_armed()


def hits(name: str) -> int:
    fp = _registry.get(name)
    return fp.hits if fp is not None else 0


# fired-counters surface in the per-process stats snapshot
_counters: dict[str, object] = {}


def _count_fired(name: str):
    counter = _counters.get(name)
    if counter is None:
        from ray_tpu_torch._private import stats

        counter = _counters[name] = stats.Count(
            f"failpoints.{name}.fired_total",
            f"failpoint {name} injected-action firings")
    counter.inc()


def check(name: str) -> tuple[str, float] | None:
    """Evaluate point `name`: count the hit, apply predicates, and return
    (action, delay_seconds) when armed-and-firing — WITHOUT applying the
    action. Sites that need custom handling (async delay, connection
    drop) use this; everything else uses fire()/fire_async()."""
    fp = _registry.get(name)
    if fp is None or fp.action == "off":
        return None
    if fp.role and fp.role != _role:
        return None
    with _lock:
        fp.hits += 1
        if fp.nth and fp.hits != fp.nth:
            return None
        if fp.once and fp.fired:
            return None
        if fp.p < 1.0 and _rng.random() >= fp.p:
            return None
        fp.fired += 1
    _count_fired(name)
    logger.warning("failpoint %s firing: %s (hit %d, role %s, pid %d)",
                   name, fp.action, fp.hits, _role or "?", os.getpid())
    return fp.action, fp.ms / 1000.0


def _hard_exit(name: str):
    logger.error("failpoint %s: hard-killing pid %d", name, os.getpid())
    os._exit(EXIT_CODE)


def fire(name: str) -> str | None:
    """Apply point `name` at a synchronous seam. Sleeps for `delay`,
    raises FailpointError for `raise`, kills the process for `exit`;
    returns "drop_conn" (the site handles it) or None."""
    act = check(name)
    if act is None:
        return None
    kind, delay = act
    if kind == "delay":
        time.sleep(delay)
        return None
    if kind == "raise":
        raise FailpointError(name)
    if kind == "exit":
        _hard_exit(name)
    return kind


def fire_strict(name: str) -> None:
    """fire() for seams with NO connection to drop: an armed action must
    never be a silent no-op (a chaos schedule would read as exercised-
    and-passing with nothing injected), so `drop_conn` degrades to
    `raise` here."""
    if fire(name) == "drop_conn":
        raise FailpointError(name)


async def fire_async(name: str) -> str | None:
    """fire() for asyncio seams: `delay` awaits instead of blocking the
    event loop."""
    act = check(name)
    if act is None:
        return None
    kind, delay = act
    if kind == "delay":
        import asyncio

        await asyncio.sleep(delay)
        return None
    if kind == "raise":
        raise FailpointError(name)
    if kind == "exit":
        _hard_exit(name)
    return kind


# arm from the environment at import (spawned runtime processes inherit
# RAY_TPU_TORCH_FAILPOINTS from their parent)
if os.environ.get(ENV_VAR):
    try:
        configure(os.environ[ENV_VAR])
    except ValueError:
        logger.exception("invalid %s; starting with no failpoints armed",
                         ENV_VAR)
