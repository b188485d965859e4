"""Step functions and their builders: the port's copy of the reference's
``launch/steps.py``, for every family: the transformer families (dense,
moe, vlm), the SSM, the hybrid (zamba2) and the encoder-decoder (encdec,
audio).

``train_step``, ``prefill_step`` and ``serve_step`` are the single-card
steps, with their caches (``init_cache``). The builders
(``build_train_step``, ``build_prefill_step``, ``build_decode_step``,
``build_step``) wrap them as the reference's do: (arch config x shape
config x mesh rules) -> a ``StepBundle`` whose ``fn`` is the step under
the rules' activation-sharding policy, with meta tensors standing in for
its inputs (``param_structs``, ``input_specs``: shapes and types, no
data) and the partition rules' shardings of its inputs and outputs. One
card runs the ``fn`` as it is; the dry run (``launch/dryrun.py``) runs it
on the meta stand-ins.

On a mesh of ranks (``launch/mesh.py:make_mesh``) every builder's ``fn``
is partitioned, for every family: each rank gathers the parameters whole
once a call, then runs its block with explicit collectives. The train
step (``sharded_train_step``) and the prefill run the rank's rows and its
chunk of the sequence (the SSM scan carries its state across the model
axis, the encoder-decoder gathers its memory); the decode step runs the
rank's rows against its blocks of the cache by the partition rules (each
rank the owner of a range of positions, its attention partials merged
across the model axis; a recurrent state split on one of its dims).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.act_sharding import (activation_sharding, last_position,
                                        ranks, reshard_sequence)
from ..distributed.sharding import (MeshRules, batch_shardings, batch_spec,
                                    cache_shardings, gather_tree,
                                    param_shardings, reduce_tree,
                                    replicated, token_shardings)
from ..models import (RUNS, encdec, families_run_by, ssm_lm, transformer,
                      zamba2)
from ..models.layers import PARAM_DTYPE, unembed
from ..models.model_zoo import Model, build_model
from ..optim.adamw import (AdamWConfig, apply_updates, init_state, leaves,
                           tree_map)

_ENCDEC = families_run_by("encdec")


def _check_family(cfg) -> None:
    if cfg.family not in RUNS:
        raise ValueError(f"unknown family {cfg.family!r}")


def value_and_grad(params: dict, batch: dict, cfg):
    """(loss, metrics, grads) of ``build_model(cfg).loss(params, batch)``:
    the gradients with respect to every parameter by
    ``torch.autograd.grad``, a tree shaped like ``params`` (zeros for a
    parameter the loss does not read, as under ``jax.grad``), computed on
    aliases of the parameters so that theirs stay untouched. The metrics
    come detached.

    Under an activation-sharding policy on a mesh of ranks, ``params`` are
    whole, ``batch`` is the rank's block and the loss the whole batch's
    (on every rank); the backward starts from 1 / mesh.size, so that the
    gradients are the rank's shares (``distributed/collectives.py``),
    which sum over the ranks to the loss's gradient."""
    # leaves of the graph: aliases of the parameters, which an update may
    # then write in place once the graph is freed
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = build_model(cfg).loss(live, batch)
    flat = [t for _, t in leaves(live)]
    pol = ranks()
    seed = None if pol is None else torch.full_like(loss, 1 / pol.mesh.size)
    grads = torch.autograd.grad(loss, flat, grad_outputs=seed,
                                allow_unused=True)
    it = iter([torch.zeros_like(t) if g is None else g
               for t, g in zip(flat, grads)])
    del live, flat
    grads = tree_map(lambda _: next(it), params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def train_step(params: dict, opt_state: dict, batch: dict, cfg,
               opt: AdamWConfig | None = None):
    """One training step: the loss of ``batch`` (``tokens``, ``labels``
    and, for the encoder families, ``frames``), its gradients with respect
    to every parameter (``value_and_grad``), and one AdamW step (``opt``,
    the default ``AdamWConfig()`` when None). As the reference's step, the
    model runs with ``remat="full"`` where cfg says "none" and
    ``loss_chunk`` 512 where cfg says 0. ``params`` and ``opt_state`` are
    updated in place (the reference's step donates them). Returns
    (params, opt_state, {**the loss's metrics, "grad_norm", "lr"}).

    On the card the forward runs kernels 5 and 7, once in the forward and
    once more in the backward's recompute of each checkpointed block; the
    backward differentiates their plain versions."""
    _check_family(cfg)
    cfg = _step_cfg(cfg)
    _, metrics, grads = value_and_grad(params, batch, cfg)
    params, opt_state, opt_metrics = apply_updates(params, grads, opt_state,
                                                   opt or AdamWConfig())
    return params, opt_state, {**metrics, **opt_metrics}


def _step_cfg(cfg):
    """The model as the reference's train step runs it: remat "full" where
    cfg says "none", loss_chunk 512 where it says 0."""
    return cfg.replace(remat="full" if cfg.remat == "none" else cfg.remat,
                       loss_chunk=cfg.loss_chunk or 512)


def sharded_train_step(p_local: dict, o_local: dict, b_local: dict, cfg,
                       opt: AdamWConfig, rules: MeshRules, p_sh,
                       tokens: tuple):
    """``train_step`` partitioned over a mesh of ranks (``rules.mesh``):
    ``p_local`` and ``o_local`` hold the rank's blocks of the parameters
    and moments by their train specs ``p_sh`` (FSDP at rest), ``b_local``
    its rows and sequence chunk of the (B, S) ``tokens``
    (``token_shardings``). The rank

      1. gathers the whole parameter tree, once a step and outside
         autograd (``gather_tree``: an all_gather a sharded dim of each
         leaf). A layer-by-layer gather would hold one layer at a time
         but would run again inside each checkpointed block's recompute,
         twice the gathers; the whole tree costs a replica of the
         parameters on every rank for the step;
      2. runs ``value_and_grad`` on its block under the policy: its
         attention, MoE and loss exchange what they need, and its
         gradients are its shares of the whole loss's;
      3. reduce-scatters each gradient to its block by the leaf's train
         spec and sums it over the axes the spec leaves out
         (``NamedSharding.reduce``): the sum of the shares, which is the
         gradient of the loss, the mean over every token of the batch;
      4. runs AdamW on its blocks, the global norm summed once over the
         mesh.

    Updates ``p_local`` and ``o_local`` in place and returns them with
    the metrics, scalars equal on every rank."""
    _, metrics, grads = sharded_value_and_grad(p_local, b_local,
                                               _step_cfg(cfg), rules, p_sh,
                                               tokens)
    p_local, o_local, opt_metrics = apply_updates(p_local, grads, o_local,
                                                  opt, shardings=p_sh)
    return p_local, o_local, {**metrics, **opt_metrics}


def sharded_value_and_grad(p_local: dict, b_local: dict, cfg,
                           rules: MeshRules, p_sh, tokens: tuple):
    """Steps 1-3 of ``sharded_train_step`` with ``cfg`` as it is: (loss,
    metrics, the rank's blocks of the gradients), the loss and metrics
    the whole batch's on every rank."""
    with torch.no_grad():
        whole = gather_tree(p_local, p_sh)
    with _policy(rules, tokens):
        loss, metrics, grads = value_and_grad(whole, b_local, cfg)
    del whole
    return loss, metrics, reduce_tree(grads, p_sh)


def prefill_step(params: dict, tokens: torch.Tensor, cfg,
                 frames: torch.Tensor | None = None):
    """tokens: (B, S). The SSM, hybrid and encoder-decoder families return
    the last-token logits (B, V) f32: the family's ``hidden`` and the
    unembed of the last position only (tied for the SSM); the
    encoder-decoder family takes the encoder's ``frames`` (B, S_enc, d)
    and raises without them. The transformer families return
    ``prefill``'s last-token logits (B, V) and its KV cache
    (L, B, S, KH, D).

    The reference's transformer step returns ``logits[:, -1]`` of those
    (B, V) logits, the last vocabulary entry of each row, shape (B,)
    (ROADMAP Queue 3); the port returns the logits themselves.

    Under a policy on a mesh of ranks tokens are the rank's block (B/D,
    S/M), the logits are those of the sequence's last position on every
    rank of the model axis, and the KV the rank's positions'."""
    _check_family(cfg)
    if (frames is not None) != (cfg.family in _ENCDEC):
        raise ValueError(f"family {cfg.family!r}: the encoder-decoder "
                         "families take frames, and only they")
    if cfg.family in transformer.FAMILIES:
        return transformer.prefill(params, tokens, cfg)
    if cfg.family == "ssm":
        x = ssm_lm.hidden(params, tokens, cfg)
        cfg = cfg.replace(tie_embeddings=True)
    elif cfg.family == "hybrid":
        x = zamba2.hidden(params, tokens, cfg)
    else:
        x = encdec.hidden(params, frames, tokens, cfg)
    return unembed(params, last_position(x), cfg)[:, 0]


def init_cache(cfg, batch: int, max_len: int, optimized: bool | str = False,
               dtype=PARAM_DTYPE, device=None, enc_len: int = 1024) -> dict:
    """The cache ``serve_step`` takes with ``optimized``: for the
    transformer families (L, B, S, KH, D) of ``dtype`` with
    ``optimized=False``, the KH-major (L, B, KH, S, D) otherwise; the
    other families' caches whatever ``optimized`` says: the SSM's
    recurrent state, the hybrid's states and shared-block KV, the
    encoder-decoder's self-attention KV and ``enc_len`` positions of
    cross KV."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return ssm_lm.init_cache(cfg, batch, max_len, device=device)
    if cfg.family == "hybrid":
        return zamba2.init_cache(cfg, batch, max_len, dtype, device)
    if cfg.family in _ENCDEC:
        return encdec.init_cache(cfg, batch, max_len, enc_len, dtype, device)
    init = transformer.init_cache_v2 if optimized else transformer.init_cache
    return init(cfg, batch, max_len, dtype, device)


def serve_step(params: dict, cache: dict, token: torch.Tensor, pos, cfg,
               optimized: bool | str = False):
    """One decode step: token (B,) -> (logits (B, V) f32, cache), the
    cache updated in place. For the transformer families ``optimized``
    picks the implementation as the reference's ``build_decode_step``:
    False ``decode_step``, "v2" ``decode_step_v2``, True or "v3"
    ``decode_step_v3`` (the latter two over ``init_cache_v2`` caches).
    The other families run their own step whatever it says."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return ssm_lm.decode_step(params, cache, token, pos, cfg)
    if cfg.family == "hybrid":
        return zamba2.decode_step(params, cache, token, pos, cfg)
    if cfg.family in _ENCDEC:
        return encdec.decode_step(params, cache, token, pos, cfg)
    if not optimized:
        return transformer.decode_step(params, cache, token, pos, cfg)
    step = transformer.decode_step_v2 if optimized == "v2" \
        else transformer.decode_step_v3
    return step(params, cache, token, pos, cfg)


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------
@dataclass
class StepBundle:
    name: str
    fn: Callable                 # the step, run as it is on one card
    in_specs: tuple              # meta tensors (positional)
    in_shardings: tuple
    out_shardings: Any           # tree, or a sharding for a whole subtree
    donate: tuple = ()           # arguments the step updates in place


def param_structs(model: Model) -> dict:
    """The model's parameters on meta: ``init`` run there, which draws
    nothing (the shapes and types of the real tree, from the same code)."""
    return model.init(0, device="meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta stand-ins for every model input of this cell, with the
    reference's shapes and types (int32 tokens, f32 frames)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        out = {"tokens": _meta((b, s), torch.int32)}
        if shape.kind == "train":
            out["labels"] = _meta((b, s), torch.int32)
        if cfg.encoder_layers:
            out["frames"] = _meta((b, s, cfg.d_model), torch.float32)
        return out
    # decode: one new token against a seq_len KV cache
    return {"token": _meta((b,), torch.int32),
            "pos": _meta((), torch.int32)}


def _policy(rules: MeshRules, tokens: tuple | None = None):
    return activation_sharding(rules.mesh, rules.data_axes, rules.model_axis,
                               tokens)


def _check_ranks(shape: ShapeConfig, rules: MeshRules) -> None:
    """Raise where the partitioned step cannot split ``shape``'s tokens on
    the mesh of ranks: rows over the data axes, the sequence over the
    model axis."""
    m, d = rules.model_size, rules.data_size
    if shape.global_batch % d or shape.seq_len % m:
        raise ValueError(f"{shape.global_batch} x {shape.seq_len} tokens do "
                         f"not divide over {d} data x {m} model ranks")


def build_train_step(cfg: ModelConfig, shape: ShapeConfig,
                     rules: MeshRules,
                     opt: AdamWConfig | None = None) -> StepBundle:
    """``fn(params, opt_state, batch)`` is ``train_step`` (remat "full",
    loss_chunk 512 where cfg says none) under the policy; it updates the
    parameters and the state in place and returns them with the
    metrics.

    On a mesh of ranks ``fn(p_local, o_local, b_local)`` is
    ``sharded_train_step``: it takes and updates the rank's blocks of the
    parameters and moments by ``in_shardings`` (``sharding.place`` cuts
    them from whole trees) and of the batch, rows over the data axes and
    the sequence over the model axis (``token_shardings``). Every family
    runs on any mesh whose ranks divide the batch and the sequence."""
    opt = opt or AdamWConfig()
    p_sds = param_structs(build_model(cfg))
    o_sds = init_state(p_sds)
    b_sds = input_specs(cfg, shape)
    p_sh = param_shardings(p_sds, rules, "train")
    o_sh = {"mu": param_shardings(o_sds["mu"], rules, "train"),
            "nu": param_shardings(o_sds["nu"], rules, "train"),
            "step": replicated(rules)}
    if rules.mesh.place is None:
        def fn(params, opt_state, batch):
            with _policy(rules):
                return train_step(params, opt_state, batch, cfg, opt)
        b_sh = batch_shardings(b_sds, rules)
    else:
        _check_ranks(shape, rules)
        tokens = (shape.global_batch, shape.seq_len)

        def fn(p_local, o_local, b_local):
            return sharded_train_step(p_local, o_local, b_local, cfg, opt,
                                      rules, p_sh, tokens)
        b_sh = token_shardings(b_sds, rules)
    return StepBundle(
        name="train_step", fn=fn, in_specs=(p_sds, o_sds, b_sds),
        in_shardings=(p_sh, o_sh, b_sh),
        # every metric is a replicated scalar
        out_shardings=(p_sh, o_sh, replicated(rules)), donate=(0, 1))


def _split_dim(sharding, rules: MeshRules, lead: int) -> int | None:
    """The dim that ``sharding``'s spec splits over the model axis, less
    ``lead`` leading dims (a stacked leaf's layer dim); None if none."""
    for i, entry in enumerate(sharding.spec):
        if rules.model_axis in (entry if isinstance(entry, tuple)
                                else (entry,)):
            return i - lead
    return None


def _cache_split_dims(c_sh, rules: MeshRules) -> dict:
    """Each cache leaf's name -> the dim of its per-layer block that the
    model axis splits (``act_sharding.cache_split``): the stacked KV
    leaves less their layer dim, the recurrent states of the ``mamba``
    list as they are."""
    out = {}
    for name, sh in c_sh.items():
        if name == "mamba":
            out.update({k: _split_dim(s, rules, 0)
                        for k, s in sh[0].items()})
        elif sh.spec:
            out[name] = _split_dim(sh, rules, 1)
    return out


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                       rules: MeshRules) -> StepBundle:
    """``fn(params, batch)`` is ``prefill_step`` under the policy: the
    last-token logits (B, V) f32 and, for the transformer families, the KV
    cache. The reference's transformer bundle returns ``logits[:, -1]``,
    (B,) (ROADMAP Queue 3); the port keeps the logits.

    On a mesh of ranks ``fn(p_local, b_local)`` takes the rank's blocks of
    the parameters by their serve specs (gathered whole once a call) and
    of the batch by ``token_shardings``; it returns the rank's rows of the
    logits (the last position's, on every rank of the model axis) and,
    for the transformer families, its block of the KV cache by
    ``cache_shardings``: its own positions where the rules split the
    sequence, else moved there by an all-to-all over the model axis."""
    b = shape.global_batch
    p_sds = param_structs(build_model(cfg))
    b_sds = input_specs(cfg, shape)
    p_sh = param_shardings(p_sds, rules, "serve")
    logits = batch_shardings(_meta((b, cfg.vocab_size), torch.float32), rules)
    c_sh = None
    if cfg.family in transformer.FAMILIES:
        c_sh = cache_shardings(init_cache(cfg, b, shape.seq_len,
                                          device="meta"), rules)
    if rules.mesh.place is None:
        def fn(params, batch):
            with _policy(rules):
                return prefill_step(params, batch["tokens"], cfg,
                                    frames=batch.get("frames"))
        b_sh = batch_shardings(b_sds, rules)
    else:
        _check_ranks(shape, rules)
        tokens = (b, shape.seq_len)
        dims = None if c_sh is None else \
            {k: _split_dim(s, rules, 0) for k, s in c_sh.items()}

        def fn(p_local, b_local):
            with torch.no_grad():
                whole = gather_tree(p_local, p_sh)
                with _policy(rules, tokens):
                    out = prefill_step(whole, b_local["tokens"], cfg,
                                       frames=b_local.get("frames"))
                    if dims is None:
                        return out
                    # (L, B, S, KH, D): the sequence is dim 2
                    return out[0], {k: reshard_sequence(t, 2, dims[k])
                                    for k, t in out[1].items()}
        b_sh = token_shardings(b_sds, rules)
    return StepBundle(
        name="prefill_step", fn=fn, in_specs=(p_sds, b_sds),
        in_shardings=(p_sh, b_sh),
        out_shardings=logits if c_sh is None else (logits, c_sh))


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig,
                      rules: MeshRules,
                      optimized: bool | str = False) -> StepBundle:
    """``fn(params, cache, token, pos)`` is ``serve_step`` under the
    policy, the cache updated in place. ``optimized`` (§Perf): the
    transformer families switch decode implementations -- "v2" ``decode_
    step_v2``, True or "v3" ``decode_step_v3``, over KH-major caches; the
    other families run their own step. The encoder families' cache holds
    4096 positions of memory, as the reference's.

    On a mesh of ranks ``fn(p_local, c_local, token, pos)`` takes the
    rank's blocks of the parameters (serve specs, gathered whole once a
    call), of the cache by ``cache_shardings`` and of the token's rows by
    ``batch_shardings``, and runs in the rows layout: every model rank
    holds the rows whole and its blocks of the cache, which it updates in
    place (the owner of ``pos`` writes the token's K and V where the rules
    split positions). What crosses ranks in a step grows with the rows and
    the model's widths, never with the cache (``layers.cache_attend``,
    ``mamba2._ssd_decode``), except where the rules split a KV cache on
    its head dim (a rank's positions fewer than the head's dims): its
    scores are summed over the model axis."""
    b = shape.global_batch
    p_sds = param_structs(build_model(cfg))
    p_sh = param_shardings(p_sds, rules, "serve")
    c_sds = init_cache(cfg, b, shape.seq_len, optimized, device="meta",
                       enc_len=4096)
    t_sds = _meta((b,), torch.int32)
    c_sh = cache_shardings(c_sds, rules)
    if rules.mesh.place is None:
        def fn(params, cache, token, pos):
            with _policy(rules):
                return serve_step(params, cache, token, pos, cfg, optimized)
    else:
        rows = batch_spec(b, rules)[0]
        rows = () if rows is None else \
            (rows if isinstance(rows, tuple) else (rows,))
        dims = _cache_split_dims(c_sh, rules)

        def fn(p_local, c_local, token, pos):
            with torch.no_grad():
                whole = gather_tree(p_local, p_sh)
                with activation_sharding(rules.mesh, rows, rules.model_axis,
                                         layout="rows", cache=dims):
                    return serve_step(whole, c_local, token, pos, cfg,
                                      optimized)
    return StepBundle(
        name="serve_step", fn=fn,
        in_specs=(p_sds, c_sds, t_sds, _meta((), torch.int32)),
        in_shardings=(p_sh, c_sh,
                      batch_shardings(t_sds, rules), replicated(rules)),
        out_shardings=(batch_shardings(
            _meta((b, cfg.vocab_size), torch.float32), rules), c_sh),
        donate=(1,))


def build_step(cfg: ModelConfig, shape: ShapeConfig,
               rules: MeshRules) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(cfg, shape, rules)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, rules)
    return build_decode_step(cfg, shape, rules)
