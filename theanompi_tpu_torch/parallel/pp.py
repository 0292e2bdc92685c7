"""Pipeline parallelism: GPipe over the pipe axis of a
:class:`~theanompi_tpu_torch.parallel.mesh.Layout`.

Port of ``theanompi_tpu/parallel/pp.py``.  Each rank of the pipe group
is one stage holding its own ``L/pp`` consecutive layers.  The JAX
``pipeline_apply`` is one ``lax.scan``: at every tick each stage runs
its layers on one microbatch slot and hands the result to the next
stage over a chain ``ppermute``.  Here the scan is a Python loop of
``M + S - 1`` ticks over a payload (a tensor, or a dict of tensors that
travel together: the activation and, with MoE, the aux moments), and
autograd's backward is the reverse schedule.

- :func:`chain_hop` is the differentiable stage i -> i + 1 hop, over
  ``collectives.permute_all`` (one ``all_to_all_single`` a dtype; stage
  0 receives zeros), whose backward is the reversed chain (the
  transpose of ``ppermute``).
- Lockstep: every rank of every group issues the same collectives in
  the same order, in the forward, the backward and each remat replay.
  So stage 0's injection and the last stage's write are tensor-valued
  selects (``torch.where`` on this stage's flags), never Python branches
  on the stage index: every stage's graph holds the same hops, and every
  hop's backward runs on every stage.  Stages compute on the fill and
  drain ticks, as JAX's do.  The hop after the last tick, whose result
  no one reads, is not issued (by any stage).
- :func:`last_stage_value` is JAX's masked ``psum``: the last stage's
  value on every stage.  Its backward is the transpose JAX's
  vma-checked autodiff gives it — ``pvary`` (the identity), then the
  mask — so the last stage's own cotangent reaches the pipeline once.
  Where the broadcast value feeds a stage-varying computation (the
  scattered head's token slice) JAX inserts an implicit ``pvary``
  whose transpose sums the stages' cotangents; the caller puts
  ``tp.copy_to_group`` there.  :func:`pipe_mean` is JAX's ``pmean``
  over the stages (forward sum / S, backward cotangent / S).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from theanompi_tpu_torch.parallel.collectives import permute_all


def stage_index(group) -> int:
    """This rank's stage: its coordinate on the pipe ``group``."""
    return group.rank if group is not None else 0


def _chain(s: int) -> list:
    return [(i, i + 1) for i in range(s - 1)]


class _ChainHop(torch.autograd.Function):
    """Stage i's tensors to stage i + 1 (stage 0 receives zeros); the
    backward hops the cotangents back (the last stage receives
    zeros)."""

    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return tuple(permute_all(list(ts), group, _chain(group.size)))

    @staticmethod
    def backward(ctx, *gs):
        back = [(b, a) for a, b in _chain(ctx.group.size)]
        return (None, *permute_all([g.contiguous() for g in gs], ctx.group,
                                   back))


def chain_hop(ts: list, group) -> list:
    """The differentiable chain hop of ``ts`` over the pipe ``group``."""
    return list(_ChainHop.apply(group, *ts))


def _flags(group, device) -> tuple[torch.Tensor, torch.Tensor]:
    idx = stage_index(group)
    return (torch.tensor(idx == 0, device=device),
            torch.tensor(idx == group.size - 1, device=device))


def pipeline_apply(stage_fn, stage_params, x_microbatches, group):
    """Run ``M`` microbatches through the stage chain.

    - ``stage_fn(stage_params, x) -> y``: one stage's compute; ``x`` and
      ``y`` share structure, shapes and dtypes.
    - ``x_microbatches``: a tensor or a dict of tensors, each ``[M,
      ...]``: the real data on stage 0 (the other stages' copies are
      ignored).
    - returns the same structure of ``[M, ...]`` outputs, valid on the
      last stage only.
    """
    is_dict = isinstance(x_microbatches, dict)
    keys = list(x_microbatches) if is_dict else [None]
    xs = [x_microbatches[k] for k in keys] if is_dict else [x_microbatches]
    s = group.size
    m = xs[0].shape[0]
    ticks = m + s - 1
    first, last = _flags(group, xs[0].device)
    recv = [torch.zeros_like(a[0]) for a in xs]
    ys = [[torch.zeros_like(a[0]) for _ in range(m)] for a in xs]

    def pack(leaves):
        return dict(zip(keys, leaves)) if is_dict else leaves[0]

    def unpack(tree):
        return [tree[k] for k in keys] if is_dict else [tree]

    for t in range(ticks):
        tc = min(t, m - 1)      # stage 0 injects microbatch t (clipped)
        inp = [torch.where(first, a[tc], r) for a, r in zip(xs, recv)]
        out = unpack(stage_fn(stage_params, pack(inp)))
        if t >= s - 1:
            # the last stage completes microbatch t - (s - 1) at tick t
            w = t - (s - 1)
            for y, o in zip(ys, out):
                y[w] = torch.where(last, o, y[w])
        if t < ticks - 1:
            recv = chain_hop(out, group)
    return pack([torch.stack(y) for y in ys])


class _LastStageValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, group):
        _, last = _flags(group, v.device)
        ctx.last = last
        out = torch.where(last, v, torch.zeros_like(v)).contiguous()
        dist.all_reduce(out, group=group.device_group)
        return out

    @staticmethod
    def backward(ctx, g):
        return torch.where(ctx.last, g, torch.zeros_like(g)), None


def last_stage_value(value: torch.Tensor, group) -> torch.Tensor:
    """The last stage's ``value`` on every stage (a masked all-reduce
    over the pipe ``group``); the backward keeps the cotangent on the
    last stage only (see the module docstring)."""
    if group is None or group.size == 1:
        return value
    return _LastStageValue.apply(value, group)


class _PipeMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, group):
        ctx.n = group.size
        out = v.detach().clone().contiguous()
        dist.all_reduce(out, group=group.device_group)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def pipe_mean(value: torch.Tensor, group) -> torch.Tensor:
    """``lax.pmean`` over the pipe ``group``: the stages' mean, each
    stage's cotangent divided by the stage count."""
    if group is None or group.size == 1:
        return value
    return _PipeMean.apply(value, group)


def split_microbatches(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """``[B, ...]`` -> ``[M, B/M, ...]`` (``B`` must divide)."""
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(
            f"batch {b} not divisible into {n_microbatches} microbatches")
    return x.reshape((n_microbatches, b // n_microbatches) + x.shape[1:])


def merge_microbatches(y: torch.Tensor) -> torch.Tensor:
    """``[M, mb, ...]`` -> ``[M*mb, ...]``."""
    return y.reshape((-1,) + y.shape[2:])
