"""The training driver: BSP at one rank through the port's normal path.

Set-up is the BSP worker's (``Llama`` → ``build_model`` →
``compile_iter_fns``), with the mix's token batches as the model's data
and the benchmark's weights copied into its fp32 masters.  The first
``checked_steps`` steps go through ``Llama.train_iter`` as the worker
calls it (they warm every shape up); their losses, each leaf's first
gradient (the ``grads`` the optimizer's ``update`` takes on the first
step) and each leaf's change over them are kept for the check.  The window then calls
``train_iter`` on further batches until ``--seconds`` have passed, and
the card is waited for; a traced run then profiles ``trace_steps`` more
steps.  Once the peak is read, the port's state is freed and the
reference trains the same weights on the same batches.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from port_bench import check, flops, spec, weights
from port_bench.drivers import Outcome, Run, log, peak_bytes, sync
from port_bench.model import dims, port_config
from port_bench.reference import model as ref
from port_bench.trace import Capture
from port_bench.traffic import TrainBatches


def port_leaves(params: dict) -> list:
    """(name, tensor) of the port's parameter tree in its leaf order
    (``embed``, each layer's leaves, ``final_norm``, ``lm_head``)."""
    out = [("embed", params["embed"])]
    for i, lp in enumerate(params["layers"]):
        out += [(f"layers.{i}.{k}", t) for k, t in lp.items()]
    return out + [("final_norm", params["final_norm"]),
                  ("lm_head", params["lm_head"])]


class FirstGradient:
    """The first gradient as the optimizer gets it: each leaf's norm of
    the ``grads`` that the port's ``Optimizer.update(params, grads,
    state, lr)`` takes while :meth:`step` runs, matched to the named
    leaves by storage.  It reads the optimizer's interface, not its
    state, so a change of the state's layout leaves it sound; where the
    program stops handing every leaf's gradient to ``update``, it
    raises rather than read something else."""

    def __init__(self, model, leaves: list):
        self.model = model
        self.names = {t.data_ptr(): n for n, t in leaves}
        self.norms = {}
        self.active = False
        self.real = model.optimizer
        update = self.real.update

        def spy(params, grads, state, lr):
            if self.active:
                self._read(params, grads)
            return update(params, grads, state, lr)
        model.optimizer = dataclasses.replace(self.real, update=spy)

    def _read(self, params, grads) -> None:
        params, grads = list(params), list(grads)
        if len(params) != len(grads):
            raise RuntimeError(f"the optimizer took {len(params)} "
                               f"parameters and {len(grads)} gradients")
        for p, g in zip(params, grads):
            name = self.names.get(p.data_ptr())
            if name is None or tuple(g.shape) != tuple(p.shape) \
                    or name in self.norms:
                raise RuntimeError(
                    f"the optimizer took a parameter of shape "
                    f"{tuple(p.shape)} that is no named leaf of the "
                    f"model's parameter tree, or one twice: the check "
                    f"reads each leaf's gradient once, as update gets it")
            self.norms[name] = float(g.detach().double().norm())

    def step(self, model_step) -> dict:
        """Run ``model_step()``, then put the optimizer back; each
        leaf's gradient norm."""
        self.active = True
        try:
            model_step()
        finally:
            self.active = False
            self.model.optimizer = self.real
        missing = sorted(set(self.names.values()) - set(self.norms))
        if missing:
            raise RuntimeError(f"the optimizer's update never took the "
                               f"gradients of {missing[:4]} "
                               f"({len(missing)} leaves)")
        return self.norms


@torch.no_grad()
def load_weights(model, d, seed: int, device) -> None:
    """The benchmark's weights into the port's fp32 master leaves."""
    stacked = weights.make(d, seed, torch.float32, device)
    for name, t in port_leaves(model.params):
        t.copy_(weights.leaf(stacked, name))


@torch.no_grad()
def change_norms(current: dict, d, seed: int, device) -> dict:
    """Each leaf's ``‖now − start‖``: ``current`` maps names to the
    leaves as they are (an expert matrix may be a list of one tensor an
    expert); the start is drawn again, a kind at a time."""
    out = {}
    ones = {"attn_norm", "mlp_norm", "final_norm"}
    for kind in [k for k, _ in weights.random_kinds(d)] + sorted(ones):
        start = (None if kind in ones else
                 {kind: weights.draw(d, kind, seed, torch.float32, device)})
        for name, t in current.items():
            if name.split(".")[-1] != kind:
                continue
            parts = t if isinstance(t, list) else [t]
            if start is None:
                begin = [torch.ones_like(x) for x in parts]
            else:
                s = weights.leaf(start, name)
                begin = list(s) if isinstance(t, list) else [s]
            out[name] = ref.norm([a.double() - b.double()
                                  for a, b in zip(parts, begin)])
        del start
    return out


def reference_train(d, seed: int, batches: TrainBatches, sec: dict,
                    device, steps: int, pr=ref.F32,
                    rows_kept: int | None = None) -> dict:
    """The reference's ``steps`` steps from the same weights on the same
    batches: losses, each leaf's first gradient and change.
    ``rows_kept`` keeps the first rows of each batch only (a fault the
    check has to see)."""
    ref.no_tf32()
    p = weights.tree(d, weights.make(d, seed, torch.float32, device))
    params = weights.tree_tensors(p)
    for t in params:
        t.requires_grad_(True)
    state = {"t": 0}
    names = weights.leaf_names(d)
    losses, grad = [], None
    for i in range(steps):
        x, y = batches.train_batch(i)
        rows = [(torch.as_tensor(x[r], device=device),
                 torch.as_tensor(y[r], device=device))
                for r in range(x.shape[0])][:rows_kept]
        losses.append(ref.loss_and_grads(p, rows, d, pr))
        if i == 0:
            grad = {}
            for n in names:
                leaf = weights.tree_leaf(p, n)
                parts = leaf if isinstance(leaf, list) else [leaf]
                grad[n] = ref.norm([t.grad for t in parts])
        ref.adam_update(params, state, float(sec["lr"]),
                        float(sec["adam_b1"]), float(sec["adam_b2"]),
                        float(sec["adam_eps"]))
    del state
    gc.collect()
    with torch.no_grad():
        current = {n: weights.tree_leaf(p, n) for n in names}
        return {"losses": losses, "grad": grad,
                "change": change_norms(current, d, seed, device)}


def run(r: Run) -> Outcome:
    from theanompi_tpu_torch.models.llama import Llama
    from theanompi_tpu_torch.utils import Recorder

    cell, dev = r.cell, r.device
    cfg, mix = cell.config, cell.traffic
    sec = cfg["train"]
    d = dims(cfg, "train")
    if d.n_experts and float(sec["capacity_factor"]) * d.top_k \
            < d.n_experts:
        raise ValueError("the reference routes without dropping: the "
                         "capacity factor must be at least E/k")
    batches = spec.load_generator(mix["generator"])(mix, d.vocab, r.seed)
    model = Llama(port_config(cfg, "train", batches.seq_len, batches.batch),
                  device=dev)
    model.build_model(n_replicas=1)
    model.data = batches
    model.compile_iter_fns(exch_strategy=sec["exch_strategy"])
    load_weights(model, d, r.seed, dev)
    log(f"built in {time.monotonic() - r.t_start:.1f} s")
    rec = Recorder(rank=0, size=1, print_freq=1 << 30, verbose=False)
    n_check = int(mix["checked_steps"])
    grad = FirstGradient(model, port_leaves(model.params)).step(
        lambda: model.train_iter(0, rec))
    for i in range(1, n_check):
        model.train_iter(i, rec)
    prog = {"losses": rec.train_losses[:n_check], "grad": grad,
            "change": change_norms(dict(port_leaves(model.params)), d,
                                   r.seed, dev)}
    sync(dev)
    log(f"checked steps done at {time.monotonic() - r.t_start:.1f} s")

    t0 = time.monotonic()
    setup_s = t0 - r.t_start
    n = 0
    while time.monotonic() - t0 < r.seconds:
        model.train_iter(n_check + n, rec)
        n += 1
    losses = rec.train_losses[n_check:]
    sync(dev)
    t1 = time.monotonic()
    out = Outcome(attempted=n,
                  failed=sum(1 for v in losses if v != v or abs(v) > 1e30))
    tokens = batches.batch * batches.seq_len
    out.end_to_end = {"train_tokens_per_s": n * tokens / (t1 - t0),
                      "setup_s": setup_s}
    if r.trace:
        # the profiled steps come after the window, on further batches
        steps = int(mix["trace_steps"])
        cap = Capture()
        cap.start()
        for j in range(steps):
            with torch.profiler.record_function("bench.train_step"):
                model.train_iter(n_check + n + j, rec)
        cap.stop()
        work = cap.work()
        out.busy_s, out.window_s = work.busy_s(), cap.window_s
        out.breakdown = {"device_ops": work.top_ops(),
                         "idle_gaps": work.idle_gaps()}
        out.records = {
            "work": work, "window_s": cap.window_s, "steps": steps,
            "dims": d, "batch": batches.batch, "seq": batches.seq_len,
            "step_flops": flops.train_step_flops(d, batches.batch,
                                                 batches.seq_len),
            "window_steps": n, "window_wall_s": t1 - t0,
        }
    out.memory_peak_bytes = peak_bytes(dev)
    del model, rec
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        log(f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB held "
            f"before the reference")
    t_ref = time.monotonic()
    want = reference_train(d, r.seed, batches, sec, dev, n_check)
    log(f"window {t1 - t0:.1f} s, {n} steps; reference "
        f"{time.monotonic() - t_ref:.1f} s")
    out.numbers = check.train_numbers(prog, want)
    out.judged = [prog, want]
    return out
