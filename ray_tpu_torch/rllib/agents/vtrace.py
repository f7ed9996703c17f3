"""V-trace off-policy correction (IMPALA; reference:
rllib/agents/impala/vtrace_torch.py — the algorithm; the JAX package runs
its recursion as one backwards `lax.scan`). Here the recursion is a
reverse loop over T on tensors of the learner's device: a few small
launches a step of T, under no_grad.

Shapes are time-major [T, B] (B = trajectory fragments)."""

from __future__ import annotations

import torch


@torch.no_grad()
def vtrace_returns(behaviour_logp, target_logp, discounts, rewards, values,
                   bootstrap_value, clip_rho: float = 1.0,
                   clip_pg_rho: float = 1.0):
    """Compute v-trace targets vs and policy-gradient advantages.

    Args (all [T, B] except bootstrap_value [B]):
        behaviour_logp: log pi_b(a_t|x_t) from the actor that sampled.
        target_logp:    log pi(a_t|x_t) under the learner's params.
        discounts:      gamma * (1 - done_t).
        rewards, values: r_t, V(x_t).
        bootstrap_value: V(x_{T}) for the step after the fragment.
    Returns (vs, pg_advantages), both [T, B], gradient-stopped.
    """
    rhos = torch.exp(target_logp - behaviour_logp)
    clipped_rhos = torch.clamp(rhos, max=clip_rho)
    cs = torch.clamp(rhos, max=1.0)

    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (
        rewards + discounts * values_t_plus_1 - values)

    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values

    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    clipped_pg_rhos = torch.clamp(rhos, max=clip_pg_rho)
    pg_advantages = clipped_pg_rhos * (
        rewards + discounts * vs_t_plus_1 - values)
    return vs, pg_advantages
