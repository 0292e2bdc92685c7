"""Llama training at pp > 1 and with MoE experts at ep >= 1 in the port
against the JAX package, through the BSP worker.

Every run resumes the JAX model's initial state, written as a
checkpoint stamped epoch -1 in the JAX tree of its layout (the layers
stacked at pp = 2: the JAX -> port crossing at that layout), for one
epoch of 8 steps and 2 val batches with ``TM_DEBUG_SYNC=1`` (each leaf
checked equal over the ranks that must hold it equal: dense leaves over
(expert, data, seq), expert leaves over (data, seq)).  The layouts, on
a tiny config (dim 32, 4 layers, two a stage at pp = 2; MoE: 4 experts,
top-2, capacity factor 2.0 = E/k, so nothing drops and the layouts are
comparable), against the JAX worker on the same layout of fake CPU
devices:

- MoE at ep = 1, one process;
- MoE at ep = 1 over two data replicas (the aux moments meaned over
  data, as JAX's over ``batch_axes``), MoE at ep = 2, dense at pp = 2
  and MoE at pp = 2 (the head scattered over the stages, and masked to
  the last stage with ``pp_head_scatter=False``), two gloo processes
  started once for the module, the jobs run in turn;
- MoE at pp = 2 x ep = 2 on four processes launched by ``BSP().init``.

Each with SGD at lr 0.5 (a wrongly scaled gradient moves SGD; the JAX
``test_two_step_train_loss_invariant_ep2_and_tp2``), and ep = 2 and the
MoE pipeline also with Adam.  The runs' checkpoints (full arrays, rank
0 writing) load in the JAX ``Llama`` of the same layout, and the ep = 2
one restores at ep = 1 in the port (the JAX
``test_sharded_checkpoint_cross_ep_restore``).  The layout's rank map is
held against JAX ``make_mesh`` at 16 ranks with all five axes, the
refusals that remain (MoE with zero1 or the compressed wire) are
checked, and zero1, the compressed wire and elastic resume at pp = 2
train on the two gloo ranks (their flat state of JAX's global shapes).

Tolerances, fp32 throughout: per-step losses and val metrics rtol 2e-6
(the tp and sp training tests'; measured at most 5e-7).  Final
parameters atol 4e-5: at this depth the port's own pp = 1 dense run
already ends 2.0e-5 from JAX's
(SGD at lr 0.5 over 8 steps carries the packages' ~1e-7 summation
differences on; 2.0e-6 at 2 layers), and the layouts land within
1.1e-5 to 1.8e-5.
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
from theanompi_tpu_torch.models.llama import (
    Llama,
    opt_state_to_jax,
    params_to_jax,
)
from theanompi_tpu_torch.parallel.mesh import Layout, layout_coords
from theanompi_tpu_torch.utils import checkpoint as port_ckpt
from theanompi_tpu_torch.workers import bsp_worker as port_worker

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
           vocab=64, seq_len=16, batch_size=4, n_train=32, n_val=8,
           compute_dtype="float32", seed=3, exch_strategy="ici32")
MOE = dict(n_experts=4, moe_top_k=2, capacity_factor=2.0)
OPTS = {"sgd": dict(optimizer="sgd", lr=0.5),
        "adam": dict(optimizer="adam", lr=1e-2)}
#: the layouts; two replicas (ep = 2, or two data ranks) halve the
#: per-replica batch so that every layout trains on the same global
#: batch; the four-rank one runs two layers a stage
GLOBAL_BATCH = 4
LAYOUTS = {"moe": dict(MOE), "moe_dp2": dict(MOE, batch_size=2),
           "ep2": dict(MOE, ep=2, batch_size=2),
           "pp2": dict(pp=2), "pp2_moe": dict(MOE, pp=2),
           "pp2_masked": dict(MOE, pp=2, pp_head_scatter=False),
           "pp2_ep2": dict(MOE, pp=2, ep=2, batch_size=2, n_layers=4)}
#: (layout, optimizer) of the two gloo processes' jobs
PAIR_JOBS = [("moe_dp2", "sgd"), ("ep2", "sgd"), ("ep2", "adam"), ("pp2", "sgd"),
             ("pp2_moe", "sgd"), ("pp2_moe", "adam"), ("pp2_masked", "sgd")]
QUAD_JOB = ("pp2_ep2", "sgd")
JOBS = [("moe", "sgd")] + PAIR_JOBS + [QUAD_JOB]
LOSS_RTOL = 2e-6
VAL_RTOL = 2e-6
PARAM_ATOL = 1e-5
#: at 4 layers (the four-rank run) the port's own pp = 1 run ends
#: 2.0e-5 from JAX's: SGD at lr 0.5 over 8 steps carries the packages'
#: ~1e-7 summation differences on, further the deeper the stack
PARAM_ATOL_4_LAYERS = 4e-5


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: the exchange states once refused at pp > 1, each at pp = 2 (zero1
#: and the compressed wire with Adam, elastic with SGD)
PP_EXCHANGE = [dict(exch_strategy="zero1"), dict(exch_compression="int8"),
               dict(elastic=True)]


def pp_exchange_cfg(knob):
    opt = "sgd" if "elastic" in knob else "adam"
    return dict(job_cfg("pp2", opt), **knob)


def job_cfg(layout, opt):
    return dict(CFG, **OPTS[opt], **LAYOUTS[layout])


def n_replicas(cfg):
    """expert × data: the ranks the global batch splits over."""
    return GLOBAL_BATCH // cfg["batch_size"]


def n_devices(cfg):
    return cfg.get("pp", 1) * n_replicas(cfg)


def stack(tree):
    """A pp = 1 JAX parameter tree with its layers stacked (the tree of
    the pp > 1 layout: the same draws, JAX ``_init_full_params``)."""
    out = dict(tree)
    out["layers"] = {k: np.stack([lp[k] for lp in tree["layers"]])
                     for k in tree["layers"][0]}
    return out


@pytest.fixture(scope="module")
def inits(tmp_path_factory):
    """Each job's initial state: the JAX pp = 1 model of its config
    (its layers stacked at pp = 2), as an epoch -1 checkpoint."""
    states, out = {}, {}
    for job in JOBS:
        cfg = job_cfg(*job)
        key = (bool(cfg.get("n_experts")), job[1], cfg["n_layers"])
        if key not in states:
            model = JaxLlama(dict(cfg, pp=1, ep=1, batch_size=4))
            model.build_model(n_replicas=1)
            model.compile_iter_fns(mesh=make_mesh(
                data=1, devices=jax.devices("cpu")[:1]))
            states[key] = (jax.device_get(model.params),
                           jax.device_get(model.opt_state))
        params, state = states[key]
        if cfg.get("pp", 1) > 1:
            params = stack(params)
            if isinstance(state, dict):
                state = dict(state, m=stack(state["m"]),
                             v=stack(state["v"]))
        d = tmp_path_factory.mktemp(f"init_{job[0]}_{job[1]}")
        jax_save(d, 0, {"params": params, "opt_state": state},
                 {"epoch": -1, "lr": cfg["lr"]})
        out[job] = d
    return out


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
    out[name] = dict(losses=res["recorder"].train_losses,
                     val=res["final_val"], resumed_from=res["resumed_from"],
                     coords=list(res["model"].layout.coords),
                     exchange={{f"{{g}}:{{k}}": tuple(v.shape) for g, t in
                               res["model"]._exchange_trees().items()
                               for k, v in flatten(t).items()}})
pickle.dump(out, open({out!r} + str(rank), "wb"))
destroy_group()
"""


@pytest.fixture(scope="module")
def port_started(inits, tmp_path_factory):
    """Start the port's multi-process runs: the two gloo ranks' jobs (in
    turn) and the four ranks ``BSP().init`` launches, all with
    ``TM_DEBUG_SYNC=1``; they train while this process runs JAX."""
    root = tmp_path_factory.mktemp("port")
    jobs = []
    for job in PAIR_JOBS:
        d = root / "_".join(job)
        shutil.copytree(inits[job], d)
        jobs.append((job, job_cfg(*job), str(d)))
    for i, knob in enumerate(PP_EXCHANGE):
        # a zero1 state cannot resume the init's full Adam tree: those
        # start from the port's own draw
        d = root / f"exchange_{i}"
        if "elastic" in knob:
            shutil.copytree(inits[("pp2", "sgd")], d)
        jobs.append((("exchange", i), pp_exchange_cfg(knob), str(d)))
    pickle.dump(jobs, open(root / "jobs.pkl", "wb"))
    src = CHILD.format(root=str(ROOT), init=f"tcp://127.0.0.1:{free_port()}",
                       jobs=str(root / "jobs.pkl"), out=str(root / "out"))
    env = dict(os.environ, OMP_NUM_THREADS="1", TM_DEBUG_SYNC="1")
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    quad = root / "_".join(QUAD_JOB)
    shutil.copytree(inits[QUAD_JOB], quad)
    os.environ["TM_DEBUG_SYNC"] = "1"
    try:
        rule = BSP()
        rule.init(devices=["cpu"] * 4,
                  modelfile="theanompi_tpu_torch.models.llama",
                  modelclass="Llama", config=job_cfg(*QUAD_JOB), n_epochs=1,
                  checkpoint_dir=str(quad), resume=True, verbose=False)
    finally:
        del os.environ["TM_DEBUG_SYNC"]
    dirs = {j[0]: Path(j[2]) for j in jobs}
    dirs[QUAD_JOB] = quad
    return dict(root=root, procs=procs, rule=rule, dirs=dirs)


def jax_run(d, cfg):
    out = jax_worker.run(
        devices=list(range(n_devices(cfg))),
        modelfile="theanompi_tpu.models.llama", modelclass="Llama",
        config=cfg, n_epochs=1, checkpoint_dir=str(d), resume=True,
        verbose=False)
    return dict(losses=out["recorder"].train_losses,
                params=leaves(jax.device_get(out["model"].params)),
                val=out["final_val"])


@pytest.fixture(scope="module")
def jax_runs(inits, port_started, tmp_path_factory):
    out = {}
    for job in JOBS:
        d = tmp_path_factory.mktemp(f"jax_{job[0]}_{job[1]}")
        shutil.copytree(inits[job], d, dirs_exist_ok=True)
        out[job] = jax_run(d, job_cfg(*job))
    return out


@pytest.fixture(scope="module")
def port_runs(inits, port_started, jax_runs):
    """The one-process MoE run, then the started runs' results (the JAX
    runs went on meanwhile)."""
    st = port_started
    one = st["root"] / "moe_sgd"
    shutil.copytree(inits[("moe", "sgd")], one)
    res = port_worker.run(
        devices=["cpu"], modelfile="theanompi_tpu_torch.models.llama",
        modelclass="Llama", config=job_cfg("moe", "sgd"), n_epochs=1,
        checkpoint_dir=str(one), resume=True, verbose=False)
    single = dict(losses=res["recorder"].train_losses, val=res["final_val"],
                  resumed_from=res["resumed_from"])
    for p in st["procs"]:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-4000:]
    assert st["rule"].wait() == 0
    ranks = [pickle.load(open(f"{st['root'] / 'out'}{r}", "rb"))
             for r in range(2)]
    dirs = dict(st["dirs"])
    dirs[("moe", "sgd")] = one
    return {"ranks": ranks, "single": single, "dirs": dirs}


def assert_val(got, want, rtol=VAL_RTOL):
    for key in ("loss", "err", "err_top5"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   atol=1e-7, err_msg=key)


def assert_params(d, want, atol=PARAM_ATOL):
    _, trees, meta = port_ckpt.load_latest(d, ("params",))
    assert meta["epoch"] == 0
    got = leaves(trees["params"])
    assert [a.shape for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)
    return meta


def test_moe_one_rank_matches_jax(port_runs, jax_runs):
    """MoE at ep = 1, one process: losses, val metrics and the final
    parameters (the checkpoint) against the JAX worker."""
    got, want = port_runs["single"], jax_runs[("moe", "sgd")]
    assert got["resumed_from"] == [-1, None]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL, atol=0)
    assert_val(got["val"], want["val"])
    assert_params(port_runs["dirs"][("moe", "sgd")], want["params"])


@pytest.mark.parametrize("job", PAIR_JOBS, ids="_".join)
def test_two_ranks_match_jax_same_layout(port_runs, jax_runs, job):
    """Each rank's per-step losses (a mean over the replicas, combined
    over the stages) and val metrics, and the checkpoint's parameters,
    against the JAX worker on the same 2-device layout; both ranks
    resumed the JAX initial state of the layout."""
    want = jax_runs[job]
    for r in range(2):
        got = port_runs["ranks"][r][job]
        assert got["resumed_from"] == [-1, None]
        assert len(got["losses"]) == len(want["losses"]) == 8
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL, atol=0)
        assert_val(got["val"], want["val"])
    meta = assert_params(port_runs["dirs"][job], want["params"])
    cfg = job_cfg(*job)
    assert meta["world_size"] == n_replicas(cfg)
    assert meta["n_devices"] == 2


def test_layouts_are_not_math(port_runs):
    """ep and pp are layouts: every MoE layout's SGD losses are the one
    rank's (capacity factor E/k: nothing drops)."""
    want = port_runs["single"]["losses"]
    for job in (("moe_dp2", "sgd"), ("ep2", "sgd"), ("pp2_moe", "sgd"),
                ("pp2_masked", "sgd")):
        np.testing.assert_allclose(port_runs["ranks"][0][job]["losses"],
                                   want, rtol=LOSS_RTOL, atol=0)


def test_rank_coordinates(port_runs):
    """Rank r of two sits at (pipe, expert, data, model, seq) of the JAX
    mesh: the data axis at ep = 1, the expert axis at ep = 2, the pipe
    axis at pp = 2."""
    for r in range(2):
        assert port_runs["ranks"][r][("moe_dp2", "sgd")]["coords"] == \
            [0, 0, r, 0, 0]
        assert port_runs["ranks"][r][("ep2", "sgd")]["coords"] == \
            [0, r, 0, 0, 0]
        assert port_runs["ranks"][r][("pp2", "sgd")]["coords"] == \
            [r, 0, 0, 0, 0]


def test_four_ranks_pp2_ep2_match_jax(port_runs, jax_runs):
    """pp = 2 x ep = 2 (MoE, two layers a stage) on four gloo processes
    launched by ``BSP().init``, ``TM_DEBUG_SYNC=1``: losses and the
    checkpoint's parameters against the JAX 4-device mesh from the same
    init."""
    want = jax_runs[QUAD_JOB]
    meta = assert_params(port_runs["dirs"][QUAD_JOB], want["params"],
                         PARAM_ATOL_4_LAYERS)
    assert meta["world_size"] == 2 and meta["n_devices"] == 4
    assert meta["global_batch"] == 4
    np.testing.assert_allclose(meta["recorder"]["train_losses"],
                               want["losses"], rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("job", [("ep2", "adam"), ("pp2_moe", "adam"),
                                 ("pp2", "sgd")], ids="_".join)
def test_checkpoint_loads_in_jax_same_layout(port_runs, job):
    """The port's checkpoint (full arrays in the layout's JAX tree, the
    layers stacked at pp = 2) loads in the JAX ``Llama`` on the same
    layout: bitwise the checkpoint's arrays, the run's val metrics."""
    cfg = job_cfg(*job)
    d = port_runs["dirs"][job]
    _, trees, _ = port_ckpt.load_latest(d, ("params",))
    jm = JaxLlama(cfg)
    jm.build_model(n_replicas=cfg.get("ep", 1))
    jm.compile_iter_fns(mesh=make_mesh(
        data=1, pipe=cfg.get("pp", 1), expert=cfg.get("ep", 1),
        devices=jax.devices("cpu")[:n_devices(cfg)]))
    rec = JaxRecorder(verbose=False)
    assert jm.load(str(d), rec)
    for a, b in zip(leaves(jax.device_get(jm.params)),
                    leaves(trees["params"])):
        assert np.array_equal(a, b)
    vals = np.mean([jm.val_iter(j, rec) for j in range(2)], axis=0)
    assert_val(dict(zip(("loss", "err", "err_top5"), vals)),
               port_runs["ranks"][0][job]["val"])


def test_ep2_checkpoint_restores_at_ep1(port_runs):
    """The ep = 2 run's checkpoint restores in the port at ep = 1 (the
    experts whole on one rank): bitwise the checkpoint's parameters and
    optimizer moments, the ep = 2 run's val metrics."""
    job = ("ep2", "adam")
    d = port_runs["dirs"][job]
    cfg = dict(job_cfg(*job), ep=1, batch_size=4)
    _, trees, _ = port_ckpt.load_latest(d, ("params", "opt_state"))
    port = Llama(cfg, device="cpu")
    port.build_model()
    port.compile_iter_fns()
    try:
        assert port.load(str(d))
        for a, b in zip(leaves(params_to_jax(port.params)),
                        leaves(trees["params"])):
            assert np.array_equal(a, b)
        got = opt_state_to_jax(port.opt_state, port.keys)
        assert int(got["t"]) == int(trees["opt_state"]["t"]) == 8
        for k in ("m", "v"):
            for a, b in zip(leaves(got[k]), leaves(trees["opt_state"][k])):
                assert np.array_equal(a, b)
        vals = np.mean([port.val_iter(j, None) for j in range(2)], axis=0)
        assert_val(dict(zip(("loss", "err", "err_top5"), vals)),
                   port_runs["ranks"][0][job]["val"])
    finally:
        port_worker.destroy_group()


AXES5 = ("pipe", "expert", "data", "model", "seq")


@pytest.mark.parametrize("sizes", [(2, 2, 1, 2, 2), (2, 1, 2, 2, 2),
                                   (1, 2, 2, 2, 2), (2, 2, 2, 2, 1),
                                   (2, 2, 2, 1, 2), (2, 2, 4, 1, 1)])
def test_layout_map_matches_jax_make_mesh_16(sizes):
    """Rank -> (pipe, expert, data, model, seq) at 16 ranks is the JAX
    ``make_mesh`` device grid (seq fastest, pipe slowest), each group
    holds the ranks that vary along its axes alone, and every rank sees
    the same list of groups."""
    pp, ep, dp, tp, sp = sizes
    mesh = make_mesh(data=dp, model=tp, seq=sp, pipe=pp, expert=ep,
                     devices=jax.devices("cpu")[:16])
    grid = np.vectorize(lambda dv: dv.id)(mesh.devices)
    lays = [Layout(r, 16, tp, sp, pp, ep) for r in range(16)]
    assert lays[0].dp_replicas == ep * dp
    for r, lay in enumerate(lays):
        c = layout_coords(r, 16, tp, sp, pp, ep)
        assert lay.coords == c
        assert grid[c] == r
        for name, span in Layout.SPANS.items():
            idx = tuple(slice(None) if a in span else c[i]
                        for i, a in enumerate(AXES5))
            assert lay.axis_ranks(name) == tuple(
                int(x) for x in grid[idx].ravel()), name
    for name in Layout.GROUPS:
        groups = lays[0].all_groups(name)
        assert all(lay.all_groups(name) == groups for lay in lays)
        assert sorted(r for g in groups for r in g) == list(range(16))


@pytest.mark.parametrize("knob,match", [
    (dict(MOE, exch_strategy="zero1"), "zero1"),
    (dict(MOE, exch_compression="int8"), "exch_compression"),
])
def test_refusals_that_remain(knob, match):
    """MoE with zero1 or the compressed wire (the JAX package's own
    refusals), before any collective: in the model's compile and in the
    worker."""
    cfg = dict(CFG, **knob)
    model = Llama(cfg, device="cpu")
    model.build_model()
    with pytest.raises(NotImplementedError, match=match):
        model.compile_iter_fns()
    with pytest.raises(NotImplementedError, match=match):
        port_worker.run(devices=["cpu"] * cfg.get("pp", 1), rank=0,
                        world_size=cfg.get("pp", 1),
                        init_method="tcp://127.0.0.1:1", config=cfg,
                        modelfile="theanompi_tpu_torch.models.llama",
                        modelclass="Llama", verbose=False)


@pytest.mark.parametrize("knob", PP_EXCHANGE)
def test_pp2_exchange_states_train(port_runs, knob):
    """zero1, the compressed wire and elastic at pp = 2, once refused,
    train through ``bsp_worker.run`` on the two gloo ranks: the zero1
    state and the EF residuals have the global shapes of the compiled
    JAX model's on the same 2-device layout (one flat pack a stage),
    and the elastic run resumes the init checkpoint and trains bitwise
    the plain pp = 2 run."""
    from test_torch_layout_exchange import jax_flat_shapes

    i = PP_EXCHANGE.index(knob)
    for r in range(2):
        got = port_runs["ranks"][r][("exchange", i)]
        assert len(got["losses"]) == 8
        assert np.isfinite(got["losses"]).all()
        if "elastic" in knob:
            assert got["resumed_from"] == [-1, None]
            assert got["losses"] == \
                port_runs["ranks"][r][("pp2", "sgd")]["losses"]
    want = jax_flat_shapes(pp_exchange_cfg(knob), 2)
    assert bool(want) != ("elastic" in knob)
    got = port_runs["ranks"][0][("exchange", i)]["exchange"]
    assert {k: got[k] for k in want} == want


def test_ep_needs_experts_and_pp_divides():
    with pytest.raises(ValueError, match="ep > 1 requires n_experts"):
        Llama(dict(CFG, ep=2), device="cpu")
    with pytest.raises(ValueError, match="must divide by ep"):
        Llama(dict(CFG, **MOE, ep=3), device="cpu")
    with pytest.raises(ValueError, match="n_layers must divide by pp"):
        Llama(dict(CFG, pp=3), device="cpu")
