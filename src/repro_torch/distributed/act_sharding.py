"""The activation-sharding policy, plumbed via a contextvar so model code
stays mesh-agnostic: the port's copy of the reference's
``distributed/act_sharding.py``. The launch layer installs the policy
(``activation_sharding``, as the step builders do), and the attention op
asks it whether the heads divide the model axis
(``head_sharding_active``), which picks the reference's heads-major
blocked attention under ``kernels/flash_attention/ops.py``'s
``HEAD_SHARDED_ATTENTION``. Without a policy installed, it is inactive.

Not ported: ``constrain``, ``constrain_heads``, ``constrain_experts`` and
``SEQ_SHARDED_ACTIVATIONS`` with its setter. They add sharding
constraints for the XLA partitioner, which change no value; the port runs
on one card, where there is nothing to partition, so they would be the
identity (as ``kernels/interpret.py`` and ``distributed/jax_compat.py``,
the reference's JAX shims, are not ported either).
"""

from __future__ import annotations

import contextlib
import contextvars

_policy: contextvars.ContextVar = contextvars.ContextVar(
    "act_sharding_policy", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, data_axes: tuple, model_axis: str):
    token = _policy.set((mesh, data_axes, model_axis))
    try:
        yield
    finally:
        _policy.reset(token)


def head_sharding_active(num_heads: int) -> bool:
    pol = _policy.get()
    if pol is None:
        return False
    mesh, _, model_axis = pol
    return num_heads % mesh.shape[model_axis] == 0
