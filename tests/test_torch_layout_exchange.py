"""zero1, the compressed wire with error feedback, their ``.shards``
layout and elastic resume at tp·sp·pp > 1 in the port, through the BSP
worker.

The JAX worker does not run zero1 or the compressed wire at these
layouts on this jax (``shard_map`` refuses the step's ``out_specs``;
ROADMAP C), so the port is held to three things:

- the port's own ``ici32`` at the same layout (itself held to the JAX
  worker at tp = 2 × data = 2 here, rtol 2e-6), bitwise: with one or
  two data replicas the reduce-scatter sums the same pair of values per
  element as the all-reduce, and Adam on a flat shard runs the same
  elementwise ops as on each tensor;
- the JAX exchange function: each rank's first compressed mean, its
  packed gradients and residuals, against
  ``compressed_allreduce_mean`` under ``shard_map`` on a data = 2 mesh
  over that model rank's two data ranks' inputs, bitwise;
- the global regions JAX's own sharding assigns: a ``.shards`` save's
  index regions for ``opt_state`` ``m``/``v`` and ``r1``/``r2`` against
  the compiled JAX model's ``P((pipe, expert, data, model))`` sharding
  of the same layout on CPU devices, mapped to port ranks by
  ``layout_coords``.

Two gloo processes, started once, run in turn: zero1 against ``ici32``
at tp = 2, pp = 2, sp = 2 ring and Ulysses (Adam); int8 and fp8 with
error feedback at tp = 2 over 10 steps, within ``EF_RTOL`` of ``ici32``
(as ``test_torch_zero1.py``); the elastic resume of a JAX tp = 2 ×
data = 2 checkpoint at tp = 2 × data = 1 under both batch policies
against the JAX worker's resume of it on 2 devices; and a tp = 2 zero1
checkpoint resumed at tp = 1 × data = 2 and at pp = 2, refused with
the JAX reshard's words.  Four gloo processes, started once, run tp =
2 × data = 2 and pp = 2 × data = 2 under ``ici32``, ``zero1``, ``zero1``
+ int8 and ``ici32`` + int8, then resume the tp = 2 × data = 2 zero1 +
int8 ``.shards`` checkpoint for a second epoch, bitwise an
uninterrupted two-epoch run.

Tolerances, fp32 throughout: losses and val rtol 2e-6, parameters atol
1e-5 against the JAX worker (``test_torch_parallel_train.py``'s).
"""

import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_torch_parallel_train import (
    CFG,
    OPTS,
    assert_val,
    free_port,
    leaves,
)
from theanompi_tpu.models.llama import Llama as JaxLlama
from theanompi_tpu.parallel import exchange as jax_exchange
from theanompi_tpu.parallel import make_mesh
from theanompi_tpu.utils.checkpoint import save_checkpoint as jax_save
from theanompi_tpu.workers import bsp_worker as jax_worker
from theanompi_tpu_torch.utils.reshard import SPANNING_REFUSAL
from theanompi_tpu_torch.parallel.mesh import layout_coords
from theanompi_tpu_torch.utils import checkpoint as port_ckpt
from theanompi_tpu_torch.utils.sharded_checkpoint import saved_shapes
from theanompi_tpu_torch.workers import bsp_worker as port_worker

ROOT = Path(__file__).resolve().parent.parent
ADAM = dict(CFG, **OPTS["adam"])
LAYOUTS = {"tp2": dict(tp=2), "pp2": dict(pp=2),
           "ring": dict(sp=2, sp_mode="ring"),
           "ulysses": dict(sp=2, sp_mode="ulysses")}
EXCHANGES = {"ici32": {}, "zero1": dict(exch_strategy="zero1"),
             "zero1_int8": dict(exch_strategy="zero1",
                                exch_compression="int8"),
             "ici32_int8": dict(exch_compression="int8")}
#: the four-rank layouts: two data replicas of a tp = 2 or pp = 2 model
QUADS = {"tp2x2": dict(tp=2, batch_size=2), "pp2x2": dict(pp=2, batch_size=2)}
#: the compressed wire's losses against ``ici32`` over 10 steps
EF_RTOL = 1e-2
EF_STEPS = 10
LOSS_RTOL = 2e-6
PARAM_ATOL = 1e-5
POLICIES = ("global", "per_replica")


def stacked(tree):
    """A pp = 1 JAX tree with its layers stacked (the pp > 1 tree)."""
    out = dict(tree)
    out["layers"] = {k: np.stack([lp[k] for lp in tree["layers"]])
                     for k in tree["layers"][0]}
    return out


def write_inits(root):
    """The JAX Adam model's initial state as epoch -1 checkpoints: the
    layers listed (``flat``) and stacked (``stacked``, pp > 1)."""
    model = JaxLlama(ADAM)
    model.build_model(n_replicas=1)
    model.compile_iter_fns(mesh=make_mesh(data=1,
                                          devices=jax.devices("cpu")[:1]))
    params = jax.device_get(model.params)
    st = jax.device_get(model.opt_state)
    out = {}
    for name, fn in (("flat", lambda t: t), ("stacked", stacked)):
        d = root / f"init_{name}"
        jax_save(d, 0, {"params": fn(params),
                        "opt_state": dict(st, m=fn(st["m"]),
                                          v=fn(st["v"]))},
                 {"epoch": -1, "lr": ADAM["lr"]})
        out[name] = d
    return out


def jax_flat_state(cfg, n_dev):
    """The compiled JAX model of ``cfg`` on ``n_dev`` CPU devices: its
    mesh, and ``{"group:key": array}`` of its zero1 state and EF
    residuals (the arrays carry JAX's sharding)."""
    model = JaxLlama(cfg)
    dp = n_dev // (cfg.get("tp", 1) * cfg.get("sp", 1) * cfg.get("pp", 1))
    model.build_model(n_replicas=dp)
    mesh = make_mesh(data=dp, model=cfg.get("tp", 1), seq=cfg.get("sp", 1),
                     pipe=cfg.get("pp", 1), devices=jax.devices("cpu")[:n_dev])
    model.compile_iter_fns(mesh=mesh)
    out = {}
    if model._zero1:
        out.update({f"opt_state:['{k}']": a
                    for k, a in model.opt_state.items() if np.ndim(a)})
    out.update({f"ef_state:['{k}']": a for k, a in model.ef_state.items()})
    return mesh, out


def jax_flat_shapes(cfg, n_dev) -> dict:
    """``{"group:key": global shape}`` of JAX's flat exchange state for
    ``cfg`` on ``n_dev`` devices (the old files' compile checks)."""
    return {k: tuple(a.shape) for k, a in jax_flat_state(cfg, n_dev)[1]
            .items()}


CHILD = """
import pickle, shutil, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from theanompi_tpu_torch.models import base
from theanompi_tpu_torch.parallel.exchange import flat_pack
from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group
from theanompi_tpu_torch.utils.checkpoint import flatten
from theanompi_tpu_torch.workers import bsp_worker

rank, world, init = int(sys.argv[1]), {world}, {init!r}
torch.set_num_threads(1)
init_group(torch.device("cpu"), rank, world, init)
seen = {{}}


def host(t):
    return None if t is None else t.detach().numpy().copy()


real_mean = base.compressed_allreduce_mean


def spy_mean(tensors, **kw):
    # the first compressed mean of a run: its inputs and outputs
    first = "mean" not in seen
    if first:
        seen["mean"] = dict(grads=[host(t) for t in tensors],
                            r1=host(kw.get("r1")), r2=host(kw.get("r2")),
                            bucket_elems=kw.get("bucket_elems", 0))
    real_mean(tensors, **kw)
    if first:
        seen["mean"].update(out=[host(t) for t in tensors],
                            r1_out=host(kw.get("r1")),
                            r2_out=host(kw.get("r2")))


real_policy = bsp_worker._apply_elastic_policy


def spy_policy(cfg, n_replicas, *a, **k):
    seen["policy_replicas"] = n_replicas
    return real_policy(cfg, n_replicas, *a, **k)


base.compressed_allreduce_mean = spy_mean
bsp_worker._apply_elastic_policy = spy_policy
out = {{}}
for name, cfg, d, n_epochs, src in pickle.load(open({jobs!r}, "rb")):
    seen.clear()
    if src is not None:
        if rank == 0:
            shutil.copytree(src, d)
        torch.distributed.barrier()
    try:
        res = bsp_worker.run(
            devices=["cpu"] * world, rank=rank, world_size=world,
            init_method=init, modelfile="theanompi_tpu_torch.models.llama",
            modelclass="Llama", config=cfg, n_epochs=n_epochs,
            checkpoint_dir=d, resume=True, verbose=False)
    except ValueError as e:
        out[name] = dict(error=str(e), seen=dict(seen))
        continue
    m = res["model"]
    out[name] = dict(
        losses=res["recorder"].train_losses, val=res["final_val"],
        resumed_from=res["resumed_from"], seen=dict(seen),
        coords=list(m.layout.coords), batch_size=m.data.batch_size,
        lr=m.current_lr,
        norms=[host(m.params["final_norm"])] + [
            host(lp[k]) for lp in m.params["layers"]
            for k in ("attn_norm", "mlp_norm")],
        exchange={{f"{{g}}:{{k}}": tuple(v.shape) for g, t in
                   m._exchange_trees().items()
                   for k, v in flatten(t).items()}},
        flat=(None if m._fspec is None else host(flat_pack(
            m._jax_views(m._leaves()), m._fspec))))
pickle.dump(out, open({out!r} + str(rank), "wb"))
destroy_group()
"""


def start_ranks(root, world, jobs):
    """Start ``world`` gloo processes running ``jobs`` (``(name, cfg,
    dir, n_epochs, src)``: ``src`` a directory rank 0 copies to ``dir``
    first) in turn; :func:`collect` waits for them."""
    pickle.dump(jobs, open(root / "jobs.pkl", "wb"))
    src = CHILD.format(root=str(ROOT), world=world,
                       init=f"tcp://127.0.0.1:{free_port()}",
                       jobs=str(root / "jobs.pkl"), out=str(root / "out"))
    env = dict(os.environ, OMP_NUM_THREADS="1", TM_DEBUG_SYNC="1")
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return root, procs


def collect(started):
    root, procs = started
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-4000:]
    return [pickle.load(open(f"{root / 'out'}{r}", "rb"))
            for r in range(len(procs))]


def jax_run(d, cfg, n_dev, n_epochs=1):
    out = jax_worker.run(
        devices=list(range(n_dev)), modelfile="theanompi_tpu.models.llama",
        modelclass="Llama", config=cfg, n_epochs=n_epochs,
        checkpoint_dir=str(d), resume=True, verbose=False)
    return dict(losses=out["recorder"].train_losses,
                params=leaves(jax.device_get(out["model"].params)),
                val=out["final_val"], lr=float(out["model"].current_lr),
                batch_size=int(out["model"].data.batch_size))


def pair_cfg(layout, exchange, **kw):
    return dict(ADAM, **LAYOUTS[layout], **EXCHANGES[exchange], **kw)


def quad_cfg(layout, exchange):
    return dict(ADAM, **QUADS[layout], **EXCHANGES[exchange])


def ef_cfg(comp):
    """The compressed-wire jobs: ``test_torch_zero1.py``'s 10 steps at
    lr 3e-3 with the default optimizer, at tp = 2."""
    return dict(CFG, tp=2, lr=3e-3, n_train=CFG["batch_size"] * EF_STEPS,
                exch_compression=comp)


def elastic_cfg(policy):
    return dict(ADAM, tp=2, batch_size=2, elastic=True,
                elastic_batch_policy=policy)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the file: the JAX tp = 2 × data = 2 run (whose
    checkpoint the elastic resumes start from) first, then the port's
    two- and four-process jobs, which train while this process runs the
    JAX resumes."""
    root = tmp_path_factory.mktemp("layout_exchange")
    inits = write_inits(root)
    jd = root / "jax_tp2x2"
    shutil.copytree(inits["flat"], jd)
    jax_tp2x2 = jax_run(jd, quad_cfg("tp2x2", "ici32"), 4)

    def job(name, cfg, n_epochs=1, src=None, init=False):
        """A job whose run starts from ``src`` (copied), from the JAX
        init (``init``: a zero1 state cannot resume a full Adam tree),
        or from the port's own seeded draw (the same for every exchange
        of a layout)."""
        d = root / "_".join(name)
        if init:
            layers = "stacked" if cfg.get("pp", 1) > 1 else "flat"
            shutil.copytree(inits[layers], d)
        return (name, cfg, str(d), n_epochs, src)

    pair = [job((lay, ex), pair_cfg(lay, ex))
            for lay in LAYOUTS for ex in ("ici32", "zero1")]
    pair += [job(("ef", c), ef_cfg(c)) for c in ("none", "int8", "fp8")]
    pair += [job(("elastic", p), elastic_cfg(p), n_epochs=2, src=str(jd))
             for p in POLICIES]
    zero1_tp2 = str(root / "tp2_zero1")
    pair += [job(("refuse", "tp1_dp2"),
                 dict(ADAM, exch_strategy="zero1", batch_size=2,
                      elastic=True), src=zero1_tp2),
             job(("refuse", "pp2"), pair_cfg("pp2", "zero1"),
                 src=zero1_tp2)]
    quad = [job(("jax_init", "ici32"), quad_cfg("tp2x2", "ici32"),
                init=True)]
    quad += [job((lay, ex), quad_cfg(lay, ex))
             for lay in QUADS for ex in EXCHANGES]
    quad += [job(("resume", "zero1_int8"), quad_cfg("tp2x2", "zero1_int8"),
                 n_epochs=2, src=str(root / "tp2x2_zero1_int8")),
             job(("uninterrupted", "zero1_int8"),
                 quad_cfg("tp2x2", "zero1_int8"), n_epochs=2)]
    for sub in ("pair", "quad"):
        (root / sub).mkdir()
    pairs = start_ranks(root / "pair", 2, pair)
    quads = start_ranks(root / "quad", 4, quad)
    jax_elastic = {}
    for p in POLICIES:
        d = root / f"jax_elastic_{p}"
        shutil.copytree(jd, d)
        jax_elastic[p] = jax_run(d, elastic_cfg(p), 2, n_epochs=2)
    return dict(pair=collect(pairs), quad=collect(quads), root=root,
                jax_tp2x2=jax_tp2x2, jax_elastic=jax_elastic)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_zero1_matches_ici32_at_two_ranks(runs, layout):
    """zero1 at one data replica of a tp = 2, pp = 2 or sp = 2 (ring,
    Ulysses) model: the per-step losses and the val metrics bitwise the
    same layout's ``ici32`` (after the pipe sum and the f32 seq mean
    the reduce-scatter over one replica is the identity, and Adam on
    the flat shard the same elementwise ops), on both ranks."""
    for r in range(2):
        got = runs["pair"][r][(layout, "zero1")]
        want = runs["pair"][r][(layout, "ici32")]
        assert got["resumed_from"] is None
        assert len(got["losses"]) == 8
        assert got["losses"] == want["losses"]
        assert got["val"] == want["val"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_zero1_state_has_jax_shapes(runs, layout):
    """The zero1 state of each layout has the global shape of the
    compiled JAX model's on the same 2-device layout."""
    want = jax_flat_shapes(pair_cfg(layout, "zero1"), 2)
    got = runs["pair"][0][(layout, "zero1")]["exchange"]
    assert want and {k: got[k] for k in want} == want


@pytest.mark.parametrize("comp", ["int8", "fp8"])
def test_compressed_wire_with_ef_at_tp2(runs, comp):
    """int8 and fp8 with error feedback at tp = 2: 10 steps within
    ``EF_RTOL`` of ``ici32``, the residuals shaped as JAX's."""
    for r in range(2):
        got = runs["pair"][r][("ef", comp)]
        want = runs["pair"][r][("ef", "none")]["losses"]
        assert len(got["losses"]) == EF_STEPS
        np.testing.assert_allclose(got["losses"], want, rtol=EF_RTOL)
        assert got["losses"] != want          # the wire does compress
    shapes = jax_flat_shapes(ef_cfg(comp), 2)
    assert set(shapes) == {"ef_state:['r1']", "ef_state:['r2']"}
    ex = runs["pair"][0][("ef", comp)]["exchange"]
    assert {k: ex[k] for k in shapes} == shapes


def test_pp_flat_order_is_jax_stacked_leaf_order(runs):
    """At pp = 2 a stage's flat pack is ``jax.tree.leaves`` of JAX's
    stacked local tree (embed, final_norm, each stacked layer leaf
    whole, lm_head), raveled: the zero1 run's final parameters packed
    against its checkpoint's stage slices."""
    d = runs["root"] / "pp2_zero1"
    _, trees, _ = port_ckpt.load_latest(d, ("params",))
    full = trees["params"]
    n_loc = CFG["n_layers"] // 2
    for r in range(2):
        stage = runs["pair"][r][("pp2", "zero1")]["coords"][0]
        local = dict(full, layers={
            k: np.asarray(a)[stage * n_loc:(stage + 1) * n_loc]
            for k, a in full["layers"].items()})
        want = np.concatenate([np.ravel(x) for x in leaves(local)])
        flat = runs["pair"][r][("pp2", "zero1")]["flat"]
        assert np.array_equal(flat[:want.size], want)
        assert not flat[want.size:].any()


@pytest.mark.parametrize("policy", POLICIES)
def test_elastic_resume_at_tp2_matches_jax(runs, policy):
    """A JAX tp = 2 × data = 2 checkpoint resumed at tp = 2 × data = 1
    with ``elastic=True`` on two gloo ranks: the elastic policy gets the
    data replicas (1; the world, 2, would halve the batch), and the
    batch, lr, losses, val and final parameters are the JAX worker's
    resume of the same checkpoint on 2 devices."""
    want = runs["jax_elastic"][policy]
    for r in range(2):
        got = runs["pair"][r][("elastic", policy)]
        assert got["seen"]["policy_replicas"] == 1
        assert got["resumed_from"] == [0, None]
        assert got["batch_size"] == want["batch_size"]
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-7)
        assert len(got["losses"]) == len(want["losses"]) > 8
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL, atol=0)
        assert_val(got["val"], want["val"])
    _, trees, meta = port_ckpt.load_latest(
        runs["root"] / f"elastic_{policy}", ("params",))
    assert meta["epoch"] == 1 and meta["world_size"] == 1
    for a, b in zip(leaves(trees["params"]), want["params"]):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("target", ["tp1_dp2", "pp2"])
def test_spanning_zero1_checkpoint_refused_at_another_layout(runs, target):
    """A tp = 2 zero1 checkpoint (one flat pack a model shard) resumed at
    tp = 1 × data = 2 (elastic: the reshard path) or at pp = 2 is
    refused on every rank with the JAX reshard's words."""
    for r in range(2):
        got = runs["pair"][r][("refuse", target)]
        assert SPANNING_REFUSAL in got.get("error", "")
        assert "spanning model/pipe axes (tp/pp-sharded zero1 packs)" \
            in SPANNING_REFUSAL


def test_ici32_tp2x2_matches_jax(runs):
    """The baseline the four-rank layouts are held to: the port's
    ``ici32`` at tp = 2 × data = 2 against the JAX worker on 4 CPU
    devices."""
    want = runs["jax_tp2x2"]
    for rank in runs["quad"]:
        got = rank[("jax_init", "ici32")]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL, atol=0)
        assert_val(got["val"], want["val"])
    _, trees, _ = port_ckpt.load_latest(runs["root"] / "jax_init_ici32",
                                        ("params",))
    for a, b in zip(leaves(trees["params"]), want["params"]):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("layout", list(QUADS))
def test_zero1_matches_ici32_at_four_ranks(runs, layout):
    """zero1 over two data replicas of a tp = 2 or pp = 2 model, bitwise
    the layout's ``ici32`` (two ranks sum one pair per element either
    way), on every rank."""
    for rank in runs["quad"]:
        assert rank[(layout, "zero1")]["losses"] \
            == rank[(layout, "ici32")]["losses"]
        assert rank[(layout, "zero1")]["val"] == rank[(layout, "ici32")]["val"]


@pytest.mark.parametrize("exchange", ["zero1_int8", "ici32_int8"])
def test_compressed_wire_keeps_model_replicated_leaves_equal(runs, exchange):
    """The norms, which every model rank holds whole, come out of eight
    steps on the int8 wire bitwise equal on all four tp = 2 × data = 2
    ranks: each model rank quantizes its own pack with its own chunk
    scales, and the port brings them back to model rank 0's values."""
    norms = [r[("tp2x2", exchange)]["norms"] for r in runs["quad"]]
    for other in norms[1:]:
        for a, b in zip(norms[0], other):
            assert np.array_equal(a, b)


def _jax_compressed_means(pairs):
    """JAX's ``compressed_allreduce_mean`` under ``shard_map`` over the
    recorded inputs of each pair of data ranks, all pairs in one call
    on a data = 2 × model = n mesh (the mean over ``data`` alone; one
    eager call costs what one pair's did): for each pair the mean and
    each data rank's r1 and r2 after."""
    n = len(pairs)
    mesh = make_mesh(data=2, model=n, devices=jax.devices("cpu")[:2 * n])
    ins = [rank["seen"]["mean"] for pair in pairs for rank in pair]
    stacked_g = [jnp.stack(parts) for parts in zip(*(x["grads"]
                                                      for x in ins))]
    r1 = jnp.concatenate([x["r1"] for x in ins])
    r2 = jnp.concatenate([x["r2"] for x in ins])
    be = ins[0]["bucket_elems"]
    spec = P(("model", "data"))

    def body(r1, r2, *parts):
        mean, a, b = jax_exchange.compressed_allreduce_mean(
            [p[0] for p in parts], "data", compression="int8", r1=r1,
            r2=r2, bucket_elems=be)
        return [m[None] for m in mean], a, b

    mean, a, b = jax.shard_map(
        body, mesh=mesh, in_specs=(spec, spec) + (spec,) * len(stacked_g),
        out_specs=([P("model")] * len(stacked_g), spec, spec),
        check_vma=False)(r1, r2, *stacked_g)
    a, b = (np.asarray(x).reshape(n, 2, -1) for x in (a, b))
    return [([np.asarray(x)[i] for x in mean], a[i], b[i])
            for i in range(n)]


@pytest.mark.parametrize("layout", list(QUADS))
def test_compressed_mean_bitwise_jax_per_model_rank(runs, layout):
    """Each rank's first compressed mean over its data group (its own
    model shard's or stage's packs) bitwise JAX's function over the same
    two data ranks' inputs: the mean and both residuals."""
    ranks = [r[(layout, "ici32_int8")] for r in runs["quad"]]
    by_model = {}
    for r, got in enumerate(ranks):
        p, _, d, m, _ = got["coords"]
        by_model.setdefault((p, m), {})[d] = r
    assert len(by_model) == 2
    pairs = [(ranks[pair[0]], ranks[pair[1]]) for pair in by_model.values()]
    for pair, (mean, r1, r2) in zip(pairs, _jax_compressed_means(pairs)):
        for d, got in enumerate(pair):
            seen = got["seen"]["mean"]
            assert seen["r1"].shape == r1[d].shape and not seen["r1"].any()
            for x, w in zip(seen["out"], mean):
                np.testing.assert_array_equal(x, w)
            np.testing.assert_array_equal(seen["r1_out"], r1[d])
            np.testing.assert_array_equal(seen["r2_out"], r2[d])


def _regions(path, key):
    """``{rank: (start, stop)}`` of leaf ``key`` in a ``.shards``
    checkpoint's index fragments."""
    out = {}
    for frag in sorted(Path(path).glob("index.p*.json")):
        rank = int(frag.stem.split(".p")[-1])
        entry = json.loads(frag.read_text()).get(key)
        if entry and entry["shards"]:
            (out[rank],) = [tuple(sh["index"][0]) for sh in entry["shards"]]
    return out


@pytest.mark.parametrize("layout", list(QUADS))
@pytest.mark.parametrize("exchange", ["zero1", "zero1_int8", "ici32_int8"])
def test_shards_regions_are_jax_shardings(runs, layout, exchange):
    """The ``.shards`` save's regions of ``opt_state`` ``m``/``v`` and
    ``r1``/``r2``: each rank's the one the compiled JAX model's
    ``P((pipe, expert, data, model))`` sharding gives the CPU device at
    the rank's coordinates, the global shapes JAX's."""
    cfg = quad_cfg(layout, exchange)
    mesh, state = jax_flat_state(cfg, 4)
    ck = runs["root"] / f"{layout}_{exchange}" / "ckpt_0.shards"
    index = saved_shapes(ck)
    assert state
    for key, arr in state.items():
        assert index[key] == tuple(arr.shape), key
        jax_map = arr.sharding.devices_indices_map(tuple(arr.shape))
        regions = _regions(ck, key)
        assert sorted(regions) == list(range(4))
        for r, region in regions.items():
            p, e, d, m, s = layout_coords(r, 4, model=cfg.get("tp", 1),
                                          pipe=cfg.get("pp", 1))
            (sl,) = jax_map[mesh.devices[p, e, d, m, s]]
            assert region == (sl.start, sl.stop), (key, r)


def test_shards_resume_continues_bitwise(runs):
    """tp = 2 × data = 2 under zero1 + int8: the epoch-0 ``.shards``
    checkpoint resumed for epoch 1 gives the losses and val of an
    uninterrupted two-epoch run, bitwise, on every rank."""
    for rank in runs["quad"]:
        got = rank[("resume", "zero1_int8")]
        want = rank[("uninterrupted", "zero1_int8")]
        assert got["resumed_from"] == [0, None]
        assert len(want["losses"]) == 16
        assert got["losses"] == want["losses"]
        assert got["val"] == want["val"]


def test_elastic_policy_gets_the_data_replicas(monkeypatch, tmp_path):
    """The worker hands ``_apply_elastic_policy`` the data replicas, not
    the process count: at tp = 2 on two ranks that is one replica, and
    the policy then keeps the saved global batch in one replica's
    rows."""
    meta = {"world_size": 2, "global_batch": 4}
    cfg = dict(ADAM, tp=2, batch_size=2, elastic=True)
    assert port_worker._apply_elastic_policy(cfg, 1, str(tmp_path), False,
                                             meta=meta)["batch_size"] == 4
    seen = []

    def spy(cfg, n_replicas, *a, **k):
        seen.append(n_replicas)
        raise RuntimeError("policy reached")

    monkeypatch.setattr(port_worker, "_apply_elastic_policy", spy)
    monkeypatch.setattr(port_worker, "init_group", lambda *a, **k: False)
    monkeypatch.setattr(port_worker, "resume_checkpoint",
                        lambda *a, **k: None)
    monkeypatch.setattr(port_worker.Layout, "build",
                        staticmethod(lambda *a, **k: None))
    threads = torch.get_num_threads()
    with pytest.raises(RuntimeError, match="policy reached"):
        port_worker.run(devices=["cpu", "cpu"], rank=0, world_size=2,
                        init_method="tcp://127.0.0.1:1", config=cfg,
                        modelfile="theanompi_tpu_torch.models.llama",
                        modelclass="Llama", checkpoint_dir=str(tmp_path),
                        resume=True, verbose=False)
    torch.set_num_threads(threads)
    assert seen == [1]
