"""Llama training at tp > 1 and sp > 1 in the port against the JAX
package, through the BSP worker.

Two gloo processes on the CPU, started once for the module, train in
turn (``bsp_worker.run`` in each, one world of two ranks laid out by
``parallel.mesh.Layout``) at tp = 2, at sp = 2 with ring attention and
at sp = 2 with Ulysses, each with SGD at lr 0.5 (SGD is not invariant
to a gradient's scale, so a layout that scales a gradient wrongly shows
here; the JAX ``test_sgd_training_matches_across_meshes``) and with
Adam.  Every run resumes the JAX model's initial state, written as a
checkpoint stamped epoch -1 (the JAX -> port checkpoint crossing at a
layout), for one epoch of 8 steps and 2 val batches, with
``TM_DEBUG_SYNC=1`` (the replicas' parameters checked equal over the
data and seq groups after the epoch).  This process
runs the JAX worker on the same 2-device layout of fake CPU devices and
the port's tp = 1 worker from the same checkpoint.  The tp = 2 runs'
checkpoints (rank 0 writes the gathered full arrays) load back at
tp = 1 in the port and in the JAX ``Llama``.  Four gloo processes
launched by ``BSP().init`` train data = 2 x sp = 2 against the JAX
4-device mesh.  At sp = 2 on the bf16 wire (``ici16``) the gloo ranks
are held against the JAX worker too.  zero1, the compressed wire and
elastic resume at sp = 2 train on the same two ranks (their flat state
of JAX's global shapes).  The layout's rank map and the groups
``Layout.build`` makes are checked at 8 ranks, without processes.

Tolerances, fp32 throughout: the packages and the layouts sum in other
orders (the ring merges per hop, the row-parallel sums add two partial
products, Ulysses and the ring see other block shapes), ~1e-7 relative
in a gradient.  SGD at lr 0.5 and Adam (lr*m/(sqrt(v)+eps), amplified
where |g| ~ eps) carry that on over 8 steps: per-step losses and val
metrics are held to rtol 2e-6 against JAX and the port's tp = 1 run
(measured at most 2.3e-7), final parameters to atol 1e-5 (a thousandth
of one Adam step, as ``test_torch_train.py``).
"""

import os
import pickle
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from theanompi_tpu.models.llama import Llama as JaxLlama
from theanompi_tpu.parallel import make_mesh
from theanompi_tpu.utils import Recorder as JaxRecorder
from theanompi_tpu.utils.checkpoint import save_checkpoint as jax_save
from theanompi_tpu.workers import bsp_worker as jax_worker
from theanompi_tpu_torch import BSP
from theanompi_tpu_torch.models.llama import Llama, params_to_jax
from theanompi_tpu_torch.parallel.mesh import Layout, layout_coords
from theanompi_tpu_torch.utils import checkpoint as port_ckpt
from theanompi_tpu_torch.workers import bsp_worker as port_worker

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
           vocab=64, seq_len=16, batch_size=4, n_train=32, n_val=8,
           compute_dtype="float32", seed=3, exch_strategy="ici32")
OPTS = {"sgd": dict(optimizer="sgd", lr=0.5),
        "adam": dict(optimizer="adam", lr=1e-2)}
LAYOUTS = {"tp2": dict(tp=2), "ring": dict(sp=2, sp_mode="ring"),
           "ulysses": dict(sp=2, sp_mode="ulysses")}
#: sp = 2 ring attention on the bf16 wire: the job of
#: ``test_sp_on_a_16bit_wire_matches_jax``, run by the gloo ranks
WIRE16 = ("ring", "sgd", "ici16")
#: its losses and val metrics against JAX: the f32 seq means differ in
#: the last bit, which flips the bf16 rounding of a few gradient entries
#: (2**-8 relative each) and SGD carries that on (measured 1.0e-5 over
#: 8 steps; the seq sum put on the bf16 wire instead reads 1.2e-4)
WIRE16_RTOL = 4e-5
LOSS_RTOL = 2e-6
VAL_RTOL = 2e-6
PARAM_ATOL = 1e-5
NORMS = ("attn_norm", "mlp_norm")


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_init(directory, cfg):
    """The JAX model's initial parameters and optimizer state as the
    checkpoint every run resumes (epoch -1: the run starts epoch 0)."""
    model = JaxLlama(cfg)
    model.build_model(n_replicas=1)
    model.compile_iter_fns(mesh=make_mesh(data=1,
                                          devices=jax.devices("cpu")[:1]))
    jax_save(directory, 0, {"params": jax.device_get(model.params),
                            "opt_state": jax.device_get(model.opt_state)},
             {"epoch": -1, "lr": cfg["lr"]})


def jax_run(d, cfg, n_dev):
    out = jax_worker.run(
        devices=list(range(n_dev)), modelfile="theanompi_tpu.models.llama",
        modelclass="Llama", config=cfg, n_epochs=1, checkpoint_dir=str(d),
        resume=True, verbose=False)
    return dict(losses=out["recorder"].train_losses,
                params=leaves(jax.device_get(out["model"].params)),
                val=out["final_val"])


CHILD = """
import pickle, sys
import torch
sys.path.insert(0, {root!r})
from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group
from theanompi_tpu_torch.utils.checkpoint import flatten
from theanompi_tpu_torch.workers import bsp_worker

rank = int(sys.argv[1])
init = {init!r}
torch.set_num_threads(1)
init_group(torch.device("cpu"), rank, 2, init)
out = {{}}
for name, cfg, d in pickle.load(open({jobs!r}, "rb")):
    res = bsp_worker.run(
        devices=["cpu", "cpu"], rank=rank, world_size=2, init_method=init,
        modelfile="theanompi_tpu_torch.models.llama", modelclass="Llama",
        config=cfg, n_epochs=1, checkpoint_dir=d, resume=True,
        verbose=False)
    p = res["model"].params
    out[name] = dict(
        losses=res["recorder"].train_losses, val=res["final_val"],
        resumed_from=res["resumed_from"],
        exchange={{f"{{g}}:{{k}}": tuple(v.shape) for g, t in
                   res["model"]._exchange_trees().items()
                   for k, v in flatten(t).items()}},
        norms=[{{k: lp[k].detach().numpy().copy() for k in {norms!r}}}
               for lp in p["layers"]]
        + [{{"final_norm": p["final_norm"].detach().numpy().copy()}}])
# grad_sync on hand-built per-rank gradients over a seq layout of two
from theanompi_tpu_torch.parallel import tp as tp_lib
from theanompi_tpu_torch.parallel.mesh import Layout
lay = Layout.build(1, 2)
gs = [torch.arange(12, dtype=torch.float32).reshape(3, 4) * (rank + 1)
      + 0.25 * k for k in range(3)]
out["grad_sync"] = [g.numpy().copy() for g in tp_lib.grad_sync(
    gs, {specs!r}, lay)]
pickle.dump(out, open({out!r} + str(rank), "wb"))
destroy_group()
"""
#: the specs of ``test_grad_sync_matches_jax``'s three leaves: replicated,
#: sharded on seq, sharded on model (so replicated on seq)
GS_SPECS = [(), ("seq",), (None, "model")]


@pytest.fixture(scope="module")
def inits(tmp_path_factory):
    out = {}
    for opt, kw in OPTS.items():
        d = tmp_path_factory.mktemp(f"init_{opt}")
        write_init(d, dict(CFG, **kw))
        out[opt] = d
    return out


#: the exchange states once refused at a layout, each at sp = 2 (ring)
EXCHANGE_KNOBS = [dict(exch_strategy="zero1"), dict(exch_compression="int8"),
                  dict(elastic=True)]


def exchange_cfg(knob):
    return dict(CFG, **OPTS["adam"], **LAYOUTS["ring"], **knob)


def job_cfg(layout, opt):
    return dict(CFG, **OPTS[opt], **LAYOUTS[layout])


def wire16_cfg():
    return dict(job_cfg(*WIRE16[:2]), exch_strategy=WIRE16[2])


@pytest.fixture(scope="module")
def port_runs(inits, tmp_path_factory):
    """Every (layout, optimizer) run of the two gloo ranks, in turn."""
    root = tmp_path_factory.mktemp("port2")
    jobs = []
    for layout in LAYOUTS:
        for opt in OPTS:
            d = root / f"{layout}_{opt}"
            shutil.copytree(inits[opt], d)
            jobs.append(((layout, opt), job_cfg(layout, opt), str(d)))
    d = root / "_".join(WIRE16)
    shutil.copytree(inits["sgd"], d)
    jobs.append((WIRE16, wire16_cfg(), str(d)))
    for i, knob in enumerate(EXCHANGE_KNOBS):
        # a zero1 state cannot resume the init's full Adam tree: those
        # start from the port's own draw
        d = root / f"exchange_{i}"
        if "elastic" in knob:
            shutil.copytree(inits["adam"], d)
        jobs.append((("exchange", i), exchange_cfg(knob), str(d)))
    pickle.dump(jobs, open(root / "jobs.pkl", "wb"))
    src = CHILD.format(root=str(ROOT), init=f"tcp://127.0.0.1:{free_port()}",
                       jobs=str(root / "jobs.pkl"), out=str(root / "out"),
                       norms=NORMS, specs=GS_SPECS)
    # TM_DEBUG_SYNC: the worker checks after each epoch that the data and
    # seq ranks hold equal parameters (raises on a desync)
    env = dict(os.environ, OMP_NUM_THREADS="1", TM_DEBUG_SYNC="1")
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-4000:]
    ranks = [pickle.load(open(f"{root / 'out'}{r}", "rb")) for r in range(2)]
    return {"ranks": ranks, "dirs": {j[0]: Path(j[2]) for j in jobs}}


@pytest.fixture(scope="module")
def jax_runs(inits, tmp_path_factory):
    out = {}
    for layout in LAYOUTS:
        for opt in OPTS:
            d = tmp_path_factory.mktemp(f"jax_{layout}_{opt}")
            shutil.copytree(inits[opt], d, dirs_exist_ok=True)
            out[(layout, opt)] = jax_run(d, job_cfg(layout, opt), 2)
    return out


@pytest.fixture(scope="module")
def port_tp1(inits, tmp_path_factory):
    out = {}
    for opt in OPTS:
        d = tmp_path_factory.mktemp(f"port1_{opt}")
        shutil.copytree(inits[opt], d, dirs_exist_ok=True)
        res = port_worker.run(
            devices=["cpu"], modelfile="theanompi_tpu_torch.models.llama",
            modelclass="Llama", config=dict(CFG, **OPTS[opt]), n_epochs=1,
            checkpoint_dir=str(d), resume=True, verbose=False)
        out[opt] = dict(losses=res["recorder"].train_losses,
                        val=res["final_val"])
    return out


def assert_val(got, want, rtol=VAL_RTOL):
    for key in ("loss", "err", "err_top5"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   atol=1e-7, err_msg=key)


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_matches_jax_same_layout(port_runs, jax_runs, layout, opt):
    """Per-step losses (the same on both ranks: a mean over data and
    seq) and the val metrics against the JAX worker on the same 2-device
    layout."""
    want = jax_runs[(layout, opt)]
    for r in range(2):
        got = port_runs["ranks"][r][(layout, opt)]
        assert got["resumed_from"] == [-1, None]
        assert len(got["losses"]) == len(want["losses"]) == 8
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL, atol=0)
        assert_val(got["val"], want["val"])


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_matches_port_tp1(port_runs, port_tp1, layout, opt):
    """Parallelism is a layout, not a model: the port's tp = 1 run from
    the same checkpoint."""
    got = port_runs["ranks"][0][(layout, opt)]
    np.testing.assert_allclose(got["losses"], port_tp1[opt]["losses"],
                               rtol=LOSS_RTOL, atol=0)
    assert_val(got["val"], port_tp1[opt]["val"])


@pytest.mark.parametrize("opt", list(OPTS))
def test_tp_ranks_hold_equal_norm_weights(port_runs, opt):
    """The replicated leaves (the norms) come out bitwise equal on both
    tp ranks with no reduction of their own: the copy-to-group backward
    already gives each rank the full gradient (no double count)."""
    a, b = (port_runs["ranks"][r][("tp2", opt)]["norms"] for r in range(2))
    for la, lb in zip(a, b):
        for k in la:
            assert np.array_equal(la[k], lb[k]), k


@pytest.mark.parametrize("opt", list(OPTS))
def test_tp2_checkpoint_loads_at_tp1(port_runs, jax_runs, opt):
    """The tp = 2 run's checkpoint holds full arrays (the shards
    gathered, rank 0 writing): its parameters are the JAX tp = 2 run's,
    it loads into the port at tp = 1 (bitwise the checkpoint's arrays,
    the val metrics of the run) and into the JAX ``Llama`` at tp = 1."""
    d = port_runs["dirs"][("tp2", opt)]
    _, trees, meta = port_ckpt.load_latest(d, ("params", "opt_state"))
    assert meta["epoch"] == 0
    assert meta["world_size"] == 1 and meta["n_devices"] == 2
    ck = leaves(trees["params"])
    for got, ref in zip(ck, jax_runs[("tp2", opt)]["params"]):
        np.testing.assert_allclose(got, ref, atol=PARAM_ATOL, rtol=0)
    cfg = dict(CFG, **OPTS[opt])
    run_val = port_runs["ranks"][0][("tp2", opt)]["val"]

    port = Llama(cfg, device="cpu")
    port.build_model()
    port.compile_iter_fns()
    assert port.load(str(d))
    for a, b in zip(leaves(params_to_jax(port.params)), ck):
        assert np.array_equal(a, b)
    vals = np.mean([port.val_iter(j, None) for j in range(2)], axis=0)
    assert_val(dict(zip(("loss", "err", "err_top5"), vals)), run_val)
    port_worker.destroy_group()

    jm = JaxLlama(cfg)
    jm.build_model(n_replicas=1)
    jm.compile_iter_fns(mesh=make_mesh(data=1,
                                       devices=jax.devices("cpu")[:1]))
    rec = JaxRecorder(verbose=False)
    assert jm.load(str(d), rec)
    for a, b in zip(leaves(jax.device_get(jm.params)), ck):
        assert np.array_equal(a, b)
    vals = np.mean([jm.val_iter(j, rec) for j in range(2)], axis=0)
    assert_val(dict(zip(("loss", "err", "err_top5"), vals)), run_val)


def test_sp_on_a_16bit_wire_matches_jax(port_runs, inits, tmp_path):
    """On the bf16 wire (``ici16``) at sp = 2 the seq ranks' gradients
    are meaned in f32 before the 16-bit data exchange, as JAX's autodiff
    psum over seq comes before its exchange: SGD losses and val metrics
    against the JAX worker on the same layout."""
    shutil.copytree(inits["sgd"], tmp_path, dirs_exist_ok=True)
    want = jax_run(tmp_path, wire16_cfg(), 2)
    for r in range(2):
        got = port_runs["ranks"][r][WIRE16]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=WIRE16_RTOL, atol=0)
        assert_val(got["val"], want["val"], WIRE16_RTOL)


def test_four_ranks_data2_sp2_match_jax(inits, tmp_path, tmp_path_factory):
    """data = 2 x sp = 2 (ring) on four gloo processes launched by
    ``BSP().init``: the one composition of the data axis with a
    sharding axis; against the JAX 4-device mesh from the same init."""
    cfg = dict(CFG, **OPTS["sgd"], sp=2, batch_size=2)
    shutil.copytree(inits["sgd"], tmp_path, dirs_exist_ok=True)
    jd = tmp_path_factory.mktemp("jax4")
    shutil.copytree(inits["sgd"], jd, dirs_exist_ok=True)
    want = jax_run(jd, cfg, 4)
    rule = BSP()
    rule.init(devices=["cpu"] * 4,
              modelfile="theanompi_tpu_torch.models.llama",
              modelclass="Llama", config=cfg, n_epochs=1,
              checkpoint_dir=str(tmp_path), resume=True, verbose=False)
    assert rule.wait() == 0
    _, trees, meta = port_ckpt.load_latest(tmp_path, ("params",))
    assert meta["world_size"] == 2 and meta["n_devices"] == 4
    assert meta["global_batch"] == 4
    np.testing.assert_allclose(meta["recorder"]["train_losses"],
                               want["losses"], rtol=LOSS_RTOL, atol=0)
    for got, ref in zip(leaves(trees["params"]), want["params"]):
        np.testing.assert_allclose(got, ref, atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("tp,sp", [(2, 2), (1, 2), (2, 1), (4, 2), (1, 8)])
def test_layout_map_and_groups_match_jax_mesh(tp, sp):
    """Rank -> (data, model, seq) at 8 ranks is the JAX mesh's device
    grid (seq fastest), and each axis's group holds the ranks that vary
    along it alone; every rank sees the same list of groups."""
    mesh = make_mesh(data=8 // (tp * sp), model=tp, seq=sp,
                     devices=jax.devices("cpu")[:8])
    grid = np.vectorize(lambda dv: dv.id)(mesh.devices)[0, 0]
    lays = [Layout(r, 8, tp, sp) for r in range(8)]
    assert lays[0].dp_replicas == 8 // (tp * sp)
    for r, lay in enumerate(lays):
        p, e, d, m, s = layout_coords(r, 8, tp, sp)
        assert (p, e) == (0, 0)
        assert lay.coords == (p, e, d, m, s)
        assert grid[d, m, s] == r
        for axis, line in (("data", grid[:, m, s]), ("model", grid[d, :, s]),
                           ("seq", grid[d, m, :]),
                           ("data_seq", grid[:, m, :].ravel())):
            assert lay.axis_ranks(axis) == tuple(int(x) for x in line)
    for axis in Layout.GROUPS:
        groups = lays[0].all_groups(axis)
        assert all(lay.all_groups(axis) == groups for lay in lays)
        assert sorted(r for g in groups for r in g) == list(range(8))


class _FakeDist:
    """The ``torch.distributed`` calls ``Layout.build`` makes, for one
    rank of a world of ``world``, recording the groups it creates."""

    class group:
        WORLD = "world"

    def __init__(self, rank, world):
        self.rank, self.world, self.made = rank, world, []

    def get_rank(self):
        return self.rank

    def get_world_size(self):
        return self.world

    def get_backend(self):
        return "gloo"

    def new_group(self, ranks, backend=None):
        self.made.append(tuple(ranks))
        return tuple(ranks)


@pytest.mark.parametrize("tp,sp", [(2, 2), (1, 2), (2, 1), (4, 2), (1, 8),
                                   (1, 1)])
def test_layout_build_makes_each_group_once(monkeypatch, tp, sp):
    """Every rank creates the same groups in one order, each set of
    ranks once (a size-1 axis and data_seq at sp = 1 reuse what an
    earlier axis made; the world's groups are the default group), and
    each axis's group is the one made for its ranks."""
    from theanompi_tpu_torch.parallel import mesh

    made = []
    for r in range(8):
        fake = _FakeDist(r, 8)
        monkeypatch.setattr(mesh, "dist", fake)
        lay = Layout.build(tp, sp)
        made.append(fake.made)
        assert len(set(fake.made)) == len(fake.made)
        for axis in Layout.GROUPS:
            ranks = lay.axis_ranks(axis)
            want = "world" if len(ranks) == 8 else ranks
            assert lay.groups[axis].device_group == want
    monkeypatch.undo()
    mesh.destroy_group()
    assert all(m == made[0] for m in made)
    want = {g for axis in Layout.GROUPS for g in Layout(0, 8, tp, sp)
            .all_groups(axis) if len(g) < 8}
    assert set(made[0]) == want


def test_layout_refuses_what_does_not_divide():
    with pytest.raises(ValueError, match="needs at least 4"):
        Layout(0, 2, 2, 2)
    with pytest.raises(ValueError, match="must divide the 6"):
        Layout(0, 6, 4, 1)


@pytest.mark.parametrize("knob", EXCHANGE_KNOBS)
def test_exchange_states_train_at_sp2(port_runs, knob):
    """zero1, the compressed wire and elastic resume at sp = 2 (ring, two
    seq ranks, Adam) train through ``bsp_worker.run`` where they were
    once refused: the zero1 state and the EF residuals have the global
    shapes of the compiled JAX model's on the same 2-device layout
    (seq-replicated: one data replica's ``padded``), and the elastic run
    resumes the init checkpoint and trains bitwise the plain ring
    run."""
    from test_torch_layout_exchange import jax_flat_shapes

    cfg = exchange_cfg(knob)
    i = EXCHANGE_KNOBS.index(knob)
    for r in range(2):
        got = port_runs["ranks"][r][("exchange", i)]
        assert len(got["losses"]) == 8
        assert np.isfinite(got["losses"]).all()
        if "elastic" in knob:
            assert got["resumed_from"] == [-1, None]
            assert got["losses"] == \
                port_runs["ranks"][r][("ring", "adam")]["losses"]
            assert got["exchange"] == {}
    want = jax_flat_shapes(cfg, 2)
    assert bool(want) != ("elastic" in knob)
    got = port_runs["ranks"][0][("exchange", i)]["exchange"]
    assert {k: got[k] for k in want} == want


def test_grad_sync_matches_jax(port_runs):
    """``tp.grad_sync`` on per-rank gradients (two seq ranks) against the
    JAX ``grad_sync`` under ``shard_map`` on a 2-device seq mesh: the
    mean over the axes each leaf's spec leaves out, in f32."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from theanompi_tpu.parallel import tp as jax_tp

    mesh = make_mesh(data=1, seq=2, devices=jax.devices("cpu")[:2])
    per_rank = [[np.arange(12, dtype=np.float32).reshape(3, 4) * (r + 1)
                 + 0.25 * k for k in range(3)] for r in range(2)]
    stacked = [jnp.asarray(np.stack([per_rank[r][k] for r in range(2)]))
               for k in range(3)]
    specs = [P(*sp) for sp in GS_SPECS]
    want = jax.shard_map(
        lambda *gs: tuple(jax_tp.grad_sync(list(gs), specs)),
        mesh=mesh, in_specs=(P("seq"),) * 3, out_specs=(P("seq"),) * 3,
        check_vma=False)(*stacked)
    for r in range(2):
        got = port_runs["ranks"][r]["grad_sync"]
        for k in range(3):
            np.testing.assert_allclose(got[k], np.asarray(want[k])[r],
                                       rtol=0, atol=0)
