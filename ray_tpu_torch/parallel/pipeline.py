"""Pipeline parallelism over the ``pp`` mesh axis, GPipe schedule
(``ray_tpu/parallel/pipeline.py``).

The stacked blocks get a leading ``stages`` dim (``stage_params``) that
``pipeline_param_logical_axes`` places on ``pp``, so each ``pp`` rank
holds ``stages / pp`` stages. A rotor holds one activation slot a stage;
each tick every rank applies its own stages to its slots, stage 0 takes
the next microbatch, the last stage's output is collected, and the rotor
advances one slot: within a rank a slot moves over, and the rank's last
slot goes to the next ``pp`` rank (``collectives.shift``; on a ``pp`` axis
of size 1 every slot is local and the advance is ``torch.roll``). The
classic bubble of ``stages - 1`` ticks at fill and drain remains; a slot
that holds no microbatch at a tick is not computed (``ray_tpu`` computes
and discards it), which changes no collected output.

The ``pp`` ranks run different graphs (only the first feeds, only the
last collects), so their collectives over ``pp`` are threaded on one
token (``collectives.chained``) and pair up in the backward too: the
feed's ``copy_to`` (the embedding's gradient summed over ``pp``) and
every advance. The collected outputs are summed over ``pp`` (only the
last rank's are not zeros), so every rank computes the same loss.

Numerical contract (tested): with the same weights, the pipeline forward
equals the dense forward — GPipe is a schedule, not an approximation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ray_tpu_torch.models import _tree, llama
from ray_tpu_torch.ops import rms_norm
from ray_tpu_torch.parallel.collectives import (chained_copy_to,
                                                chained_shift, reduce)
from ray_tpu_torch.parallel.mesh import axis_rank, axis_size

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    stages: int                   # a multiple of the mesh's pp
    microbatches: int             # batch must divide evenly

    def validate(self, cfg: llama.LlamaConfig, batch: int) -> None:
        if cfg.n_layers % self.stages:
            raise ValueError(
                f"n_layers={cfg.n_layers} not divisible by "
                f"stages={self.stages}")
        if batch % self.microbatches:
            raise ValueError(
                f"batch={batch} not divisible by "
                f"microbatches={self.microbatches}")
        if self.microbatches < self.stages:
            raise ValueError("need microbatches >= stages to fill the pipe")


def stage_params(params: Params, stages: int) -> Params:
    """Reshape stacked blocks [L, ...] -> [stages, L/stages, ...] (whole
    tensors, before ``spmd.shard_params``). The embed/ln_out/lm_head stay
    as they are: they run outside the rotor."""
    out = dict(params)
    out["blocks"] = {
        k: v.reshape((stages, v.shape[0] // stages) + tuple(v.shape[1:]))
        for k, v in params["blocks"].items()
    }
    return out


def pipeline_param_logical_axes(cfg: llama.LlamaConfig) -> Params:
    """Logical axes with the extra leading ``stages`` dim on blocks."""
    tree = llama.param_logical_axes(cfg)
    tree["blocks"] = {k: ("stages",) + v for k, v in tree["blocks"].items()}
    return tree


def _hidden(params: Params, tokens: torch.Tensor, cfg: llama.LlamaConfig,
            pcfg: PipelineConfig, mesh, layers) -> torch.Tensor:
    """The rotor on local shards: tokens [b, S] (this rank's batch rows)
    -> normed hidden [b, S, D], the same on every ``pp`` rank."""
    b, s = tokens.shape
    pcfg.validate(cfg, b)
    n_stages, m = pcfg.stages, pcfg.microbatches
    pp = axis_size(mesh, "pp") if mesh is not None else 1
    if n_stages % pp:
        raise ValueError(f"stages={n_stages} not divisible by pp={pp}")
    if mesh is not None and axis_size(mesh, "sp") > 1:
        raise ValueError("the pipeline runs whole sequences: sp must be 1")
    k = n_stages // pp
    first = (axis_rank(mesh, "pp") if pp > 1 else 0) * k
    mb = b // m
    positions = llama._positions(0, mb, s, tokens.device)
    token = torch.zeros((), device=tokens.device, requires_grad=True)

    x = llama._embed({"embed": llama._gathered(params, "embed", cfg, mesh)},
                     tokens, cfg, mesh)
    token, x = chained_copy_to(token, x, mesh, "pp")
    stream = x.reshape(m, mb, s, x.shape[-1])
    if layers is None:
        layers = _tree.unstack(params["blocks"])
    stages = [_tree.unstack(stage) for stage in layers]

    zeros = stream.new_zeros(stream.shape[1:])
    slots = [zeros] * k
    outputs = []
    n_ticks = m + n_stages - 1
    for t in range(n_ticks):
        if first == 0:
            slots[0] = stream[t] if t < m else zeros
        # Stage g holds microbatch t - g this tick, if there is one.
        slots = [llama.run_blocks(slot, stages[j], positions, cfg, True,
                                  mesh) if 0 <= t - first - j < m else slot
                 for j, slot in enumerate(slots)]
        if first + k == n_stages and t >= n_stages - 1:
            outputs.append(slots[-1])
        if t < n_ticks - 1:
            token, incoming = chained_shift(token, slots[-1], mesh, "pp")
            slots = [incoming] + slots[:-1]
    hidden = (torch.cat(outputs) if outputs
              else stream.new_zeros(stream.shape).reshape(b, s, -1))
    hidden = reduce(hidden, mesh, "pp") + token * 0
    return rms_norm(hidden, llama._gathered(params, "ln_out", cfg, mesh),
                    cfg.norm_eps)


def pipeline_forward_hidden(params: Params, tokens: torch.Tensor,
                            cfg: llama.LlamaConfig, pcfg: PipelineConfig,
                            *, mesh=None, layers=None):
    """Tokens [B,S] -> final hidden [B,S,D] via the GPipe rotor (under a
    mesh, a DTensor placed (batch, seq, None)). ``params`` must be
    stage-shaped (``stage_params``); ``layers`` are per-stage leaf views
    (``Optimizer.init``'s), else views of ``params``."""
    if mesh is None:
        return _hidden(params, tokens, cfg, pcfg, None, layers)
    lp, lt, _, _ = llama._on_mesh(params, tokens, mesh)
    return llama._as_dtensor(_hidden(lp, lt, cfg, pcfg, mesh, layers), mesh,
                             ("batch", "seq", None))


def pipeline_loss_fn(params: Params, tokens: torch.Tensor,
                     cfg: llama.LlamaConfig, pcfg: PipelineConfig,
                     *, mesh=None, layers=None
                     ) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE over the pipelined forward (``llama``'s chunked CE on
    this hidden)."""
    if mesh is None:
        hidden = _hidden(params, tokens, cfg, pcfg, None, layers)
    else:
        lp, lt, _, _ = llama._on_mesh(params, tokens, mesh)
        hidden = _hidden(lp, lt, cfg, pcfg, mesh, layers)
    return llama.loss_from_hidden(params, hidden, tokens, cfg, mesh=mesh)


def make_pipeline_train_step(cfg: llama.LlamaConfig, pcfg: PipelineConfig,
                             mesh, tx):
    """(state, tokens) -> (state, metrics) over stage-shaped parameters
    (``spmd.make_train_step`` for the ``pp`` axis); ``mesh`` may be None
    (every stage on this rank)."""
    from ray_tpu_torch.parallel import spmd

    def step_fn(state: spmd.TrainState, tokens: torch.Tensor):
        opt = state.opt_state
        loss, metrics = pipeline_loss_fn(state.params, tokens, cfg, pcfg,
                                         mesh=mesh,
                                         layers=opt.layers["blocks"])
        loss.backward()
        gnorm = tx.update(opt, state.step)
        return (spmd.TrainState(state.step + 1, state.params, opt),
                dict(metrics, grad_norm=gnorm))

    return step_fn
