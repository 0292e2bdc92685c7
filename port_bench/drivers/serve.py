"""The serving driver: an open loop of requests arriving on the schedule
that the mix's generator draws from the seed, served by the port's
``Engine`` over ``PagedLlamaDecoder``, which this driver steps itself.

Set-up makes the weights on the card, builds the model, the decoder
(its KV pool) and the engine, and serves one request of two prefill
chunks and a few decode steps, which builds every kernel and shape the
traffic uses; the arrivals then start and run for the mix's
``warmup_s`` so the window opens on a loaded engine.  Before each
engine step every request that is due is submitted; the window steps
the engine for ``--seconds``.  Past the window the arrivals go on, and
the engine with them (a traced run profiles its first ``trace_steps``
steps there), until every request due before the window closed has
completed; the rest are abandoned.

A request's latency runs from when it was due: its time to first token
is the engine's first token (submit + ``ttft_s``, stamped at the
engine's device fence) less the due time, so a late submission counts.
Its time per output token is the engine's ``tpot_s``.  The requests due
inside the window give the tails.  Once the peak is read and the engine
freed, the reference runs over a sample of them drawn from the seed,
the longest among it, and judges every served token.
"""

from __future__ import annotations

import gc
import inspect
import time

import numpy as np
import torch

from port_bench import check, flops, spec, weights
from port_bench.drivers import Outcome, Run, log, peak_bytes, sync
from port_bench.model import dims, port_config
from port_bench.reference import model as ref
from port_bench.trace import Capture


class Arrivals:
    """The open loop: requests submitted when due, with their due,
    submit and completion stamps."""

    def __init__(self, engine, requests, t_start: float):
        self.engine = engine
        self.requests = requests
        self.log = []
        self.open = []
        self._next(t_start)

    def _next(self, after: float) -> None:
        gap, prompt, n_out = next(self.requests)
        self.pending = {"t_due": after + gap, "prompt": prompt,
                        "n_out": n_out}

    def submit_due(self) -> None:
        while self.pending["t_due"] <= time.monotonic():
            e = self.pending
            e["t_submit"] = time.monotonic()
            e["future"] = self.engine.submit(e["prompt"],
                                             max_tokens=e["n_out"],
                                             temperature=0.0)
            self.log.append(e)
            self.open.append(e)
            self._next(e["t_due"])

    def step(self) -> None:
        """Submit what is due, then one engine step (or, with nothing
        in flight, a wait for the next arrival), then read the
        completions."""
        self.submit_due()
        if not self.engine.step():
            time.sleep(max(0.0, min(0.01, self.pending["t_due"]
                                    - time.monotonic())))
        now = time.monotonic()
        still = []
        for e in self.open:
            if e["future"].done():
                e["t_done"] = now
                e["result"] = e["future"].result()
            else:
                still.append(e)
        self.open = still


def token_times(e: dict) -> np.ndarray:
    """The delivery times of a completed request's tokens: the first at
    submit + ``ttft_s``, the last at submit + ``e2e_s``, the rest
    evenly between."""
    res = e["result"]
    n = len(res.tokens)
    t_first = e["t_submit"] + res.ttft_s
    t_last = e["t_submit"] + (res.e2e_s if res.e2e_s is not None
                              else res.ttft_s)
    if n <= 1:
        return np.array([t_first][:n])
    return np.linspace(t_first, t_last, n)


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q`` quantile (0 < q < 1)."""
    v = sorted(values)
    return v[max(0, int(np.ceil(q * len(v))) - 1)]


def _ok(e: dict) -> bool:
    res = e.get("result")
    return (res is not None and res.status == "ok"
            and len(res.tokens) == e["n_out"])


def bound_names(fn, want, what: str) -> inspect.Signature:
    """``fn``'s signature, checked to take the parameters ``want`` by
    those names: the probe reads them by name, and a program whose call
    changed has to fail here rather than be misread."""
    sig = inspect.signature(fn)
    missing = [n for n in want if n not in sig.parameters]
    if missing:
        raise RuntimeError(f"{what} takes {list(sig.parameters)}; the "
                           f"benchmark's probe reads {list(want)}")
    return sig


class Probe:
    """The traced run's instruments: a range of this driver's own around
    each of the decoder's ``decode`` and ``prefill`` calls (counted while
    the profiler runs); over the window, the model FLOPs and wall time
    of every decode call, the KV blocks that live requests hold (the
    distinct blocks in the block tables each decode call is given,
    the pool's trash block left out) and the slots that decode; and the positions each K4 launch
    is given while the profiler runs.  ``remove`` puts the decoder
    back."""

    ATTEND = ("q", "k_pool", "v_pool", "tables", "pos")

    def __init__(self, dec, decoder_module, d, n_blocks: int):
        self.dec, self.module, self.d = dec, decoder_module, d
        self.trash = int(n_blocks)
        self.capturing = self.in_window = False
        self.calls = {"decode": 0, "prefill": 0}
        self.decode_flops = self.decode_wall_s = 0.0
        self.live_blocks_peak = self.live_slots_peak = 0
        self.k4 = []
        self.decode_sig = bound_names(dec.decode,
                                      ("lengths", "tables", "active"),
                                      "the decoder's decode")
        self._attend = getattr(decoder_module, "paged_attend", None)
        if self._attend is None:
            raise RuntimeError("the decoder no longer calls paged_attend: "
                               "k4_roofline has no launches to read")
        self.attend_sig = bound_names(self._attend, self.ATTEND,
                                      "paged_attend")
        for name in self.calls:
            setattr(dec, name, self._wrap(name, getattr(dec, name)))
        decoder_module.paged_attend = self._attend_probe

    def _wrap(self, name, call):
        def wrapped(*a, **kw):
            if self.capturing:
                self.calls[name] += 1
            t = time.monotonic()
            with torch.profiler.record_function(f"bench.{name}"):
                got = call(*a, **kw)
            if name == "decode" and self.in_window:
                self.decode_wall_s += time.monotonic() - t
                arg = self.decode_sig.bind(*a, **kw).arguments
                lengths = np.asarray(arg["lengths"])
                active = np.asarray(arg["active"], bool)
                tables = np.asarray(arg["tables"])
                self.decode_flops += float(flops.serve_token_flops(
                    self.d, lengths[active].astype(np.float64)).sum())
                self.live_blocks_peak = max(
                    self.live_blocks_peak,
                    int(np.unique(tables[tables != self.trash]).size))
                self.live_slots_peak = max(self.live_slots_peak,
                                           int(active.sum()))
            return got
        return wrapped

    def _attend_probe(self, *a, **kw):
        if self.capturing:
            arg = self.attend_sig.bind(*a, **kw).arguments
            q, pos = arg["q"], arg["pos"]
            self.k4.append((tuple(q.shape), int(arg["k_pool"].shape[2]),
                            pos.clone(), arg["tables"].numel()))
        return self._attend(*a, **kw)

    def remove(self) -> list:
        """Put the decoder back; the K4 launches' (q shape, block size,
        each slot's last position, table size)."""
        self.module.paged_attend = self._attend
        for name in self.calls:
            delattr(self.dec, name)
        self.dec = None
        out = [(shape, bs, p.max(dim=1).values.tolist(), n)
               for shape, bs, p, n in self.k4]
        self.k4 = []
        return out


def build(cell, seed: int, dev, trace: bool, serve: dict | None = None):
    """The model with the benchmark's weights, its paged decoder and the
    engine, for the configuration's ``serve`` settings (``serve``
    replaces some of them), warmed up by one request of two prefill
    chunks and a few decode steps, which builds every kernel and shape
    the traffic uses; ``trace`` turns the engine's spans on.  Returns ``(decoder, engine, dims, settings)``."""
    from theanompi_tpu_torch.models.llama import Llama
    from theanompi_tpu_torch.serving.engine import Engine

    cfg, mix = cell.config, cell.traffic
    sv = dict(cfg["serve"], **(serve or {}))
    d = dims(cfg, "serve")
    dtype = getattr(torch, cfg["precision"]["compute"])
    model = Llama(port_config(cfg, "serve", int(sv["max_seq"])), device=dev,
                  params=weights.port_tree(d, weights.make(d, seed, dtype,
                                                           dev)))
    dec = model.make_decoder(
        paged=True, max_slots=int(sv["max_slots"]),
        max_seq=int(sv["max_seq"]), block_size=int(sv["block_size"]),
        n_blocks=int(sv["n_blocks"]), prefill_chunk=int(sv["prefill_chunk"]))
    eng = Engine(dec, queue_cap=int(sv["queue_cap"]), eos_id=None,
                 prefill_chunks_per_step=int(sv["prefill_chunks_per_step"]),
                 prefix_caching=bool(sv["prefix_caching"]),
                 default_deadline_s=float(mix["deadline_s"]),
                 trace_sample=1 if trace else 0)
    eng.submit(list(range(1, int(sv["prefill_chunk"]) + 2)), max_tokens=3)
    eng.run_until_idle()
    return dec, eng, d, sv


def tails(window: list, t_end: float) -> tuple[list, list]:
    """Each request's time to first token, from when it was due, and its
    time per output token; a failed request misses every limit: both
    its latencies are ``t_end`` less its due time."""
    ttft = [e["t_submit"] + e["result"].ttft_s - e["t_due"] if _ok(e)
            else t_end - e["t_due"] for e in window]
    tpot = [e["result"].tpot_s if _ok(e) else t_end - e["t_due"]
            for e in window]
    return ttft, tpot


def run(r: Run) -> Outcome:
    from theanompi_tpu_torch.serving import decoder as decoder_module

    cell, dev, mix = r.cell, r.device, r.cell.traffic
    dec, eng, d, sv = build(cell, r.seed, dev, r.trace)
    probe = (Probe(dec, decoder_module, d, int(sv["n_blocks"]))
             if r.trace else None)
    log(f"built and warm in {time.monotonic() - r.t_start:.1f} s")
    requests = spec.load_generator(mix["generator"])(mix, d.vocab, r.seed)
    arrivals = Arrivals(eng, requests, time.monotonic())
    t_warm = time.monotonic() + float(mix["warmup_s"])
    while time.monotonic() < t_warm:
        arrivals.step()
    sync(dev)

    t0 = time.monotonic()
    setup_s = t0 - r.t_start
    t1 = t0 + r.seconds
    steps = []
    if probe is not None:
        probe.in_window = True
    while time.monotonic() < t1:
        a = time.monotonic()
        arrivals.step()
        steps.append(time.monotonic() - a)
    t1 = time.monotonic()
    out = Outcome()
    if probe is not None:
        # the profiled steps come after the window, under the same load
        probe.in_window = False
        cap = Capture()
        cap.start()
        probe.capturing = True
        for _ in range(int(mix["trace_steps"])):
            arrivals.step()
        cap.stop()
        probe.capturing = False
    # the same arrivals until everything due before the close completes
    before = [e for e in arrivals.log if e["t_due"] < t1]
    while any("result" not in e for e in before):
        arrivals.step()
    eng.abandon_all("bench_end")
    out.memory_peak_bytes = peak_bytes(dev)
    if probe is not None:
        work = cap.work()
        out.busy_s, out.window_s = work.busy_s(), cap.window_s
        out.breakdown = {"device_ops": work.top_ops(),
                         "idle_gaps": work.idle_gaps()}

    window = [e for e in before if e["t_due"] >= t0]
    good = [e for e in window if _ok(e)]
    out.attempted, out.failed = len(window), len(window) - len(good)
    ttft, tpot = tails(window, time.monotonic())
    delivered = sum(int(((token_times(e) >= t0) & (token_times(e) <= t1))
                        .sum()) for e in before if _ok(e))
    late = max((e["t_submit"] - e["t_due"] for e in window), default=0.0)
    log(f"window {t1 - t0:.1f} s, {len(steps)} steps, {len(window)} "
        f"requests due, {delivered / (t1 - t0):.1f} tokens/s delivered, "
        f"submitted at most {1e3 * late:.1f} ms late; drained "
        f"{time.monotonic() - t1:.1f} s")
    out.end_to_end = {"ttft_p90_ms": 1e3 * percentile(ttft, 0.9),
                      "tpot_p90_ms": 1e3 * percentile(tpot, 0.9),
                      "setup_s": setup_s}
    if probe is not None:
        out.records = {
            "work": work, "window_s": cap.window_s, "dims": d,
            "calls": dict(probe.calls), "k4": probe.remove(),
            "step_s": steps,
            "prefill_s": [s["t1"] - s["t0"] for e in good
                          for s in e["result"].spans
                          if s["name"] == "prefill"],
            "decode_flops": probe.decode_flops,
            "decode_wall_s": probe.decode_wall_s,
            "live_blocks_peak": probe.live_blocks_peak,
        }
        log(f"live requests held at most {probe.live_blocks_peak} of the "
            f"pool's {sv['n_blocks']} KV blocks in the window; at most "
            f"{probe.live_slots_peak} of {sv['max_slots']} slots decoded")
        del probe

    if not good:
        out.numbers = {"served_gap": float("inf")}
        return out
    # the reference judges a sample of the window's requests
    rng = np.random.default_rng([r.seed % (2**63), 4])
    longest = max(range(len(good)),
                  key=lambda i: len(good[i]["prompt"]) + good[i]["n_out"])
    rest = [i for i in range(len(good)) if i != longest]
    k = min(len(rest), int(mix["check_requests"]) - 1)
    picked = [longest] + list(rng.choice(rest, size=k, replace=False))
    sample = [(good[i]["prompt"], list(good[i]["result"].tokens))
              for i in picked]
    out.judged = sample
    del eng, dec, arrivals, window, good, before
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        log(f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB held "
            f"before the reference")
    ref.no_tf32()
    dtype = getattr(torch, cell.config["precision"]["compute"])
    p = weights.make(d, r.seed, dtype, dev)
    seqs = [(torch.as_tensor(pr + tk, device=dev), len(tk))
            for pr, tk in sample]
    t_ref = time.monotonic()
    logits = ref.served_logits(p, seqs, d)
    log(f"reference {time.monotonic() - t_ref:.1f} s over "
        f"{sum(len(tk) for _, tk in sample)} served tokens")
    out.numbers = {"served_gap": check.served_gap(logits,
                                                  [tk for _, tk in sample])}
    return out
