"""The asynchronous rules of the port (EASGD, GoSGD in one process)
against the JAX package, on the CPU.

- Each merge of ``parallel.exchange`` (``elastic_*``, ``gossip_*``) and
  the engine's ``broadcast_stack``/``stacked_mean`` against the JAX
  function on one random stacked tree with an int leaf.
- The in-process trajectories from one init checkpoint at fp32 and
  dropout 0 (the packages draw dropout masks from different
  generators): the port's workers on ``devices=["cpu"] * W``, the JAX
  ones on the conftest's fake CPU devices.  GoSGD x LSTM at W = 4 (push
  probability 1, and staleness 1), EASGD x LSTM at W = 4 (and the
  ``speeds`` mode), EASGD x WResNet-10-1 at W = 2 for BN state in the
  replicas.  Losses, val numbers, the final model (the EASGD center,
  the best GoSGD replica), the gossip scores and routes.
- The engine (staging, masked steps), the feed, the entry points and
  the refusals.
"""

import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import lstm as jax_lstm
from theanompi_tpu.models import wresnet as jax_wresnet
from theanompi_tpu.parallel import exchange as jax_exchange
from theanompi_tpu.utils.checkpoint import save_checkpoint as jax_save
from theanompi_tpu.workers import easgd_worker as jax_easgd
from theanompi_tpu.workers import gosgd_worker as jax_gosgd
from theanompi_tpu.workers import replica_engine as jax_engine
from theanompi_tpu_torch import EASGD, GOSGD
from theanompi_tpu_torch.launcher import main
from theanompi_tpu_torch.models.lstm import LSTM
from theanompi_tpu_torch.models.wresnet import WResNet
from theanompi_tpu_torch.parallel import exchange
from theanompi_tpu_torch.utils.checkpoint import tree_to_flat
from theanompi_tpu_torch.workers import easgd_worker, gosgd_worker
from theanompi_tpu_torch.workers import replica_engine

LSTM_CFG = dict(vocab=64, emb_dim=8, hidden=8, maxlen=12, batch_size=4,
                n_train=128, n_val=32, compute_dtype="float32",
                dropout=0.0, lr=0.1, seed=3)
WRN_CFG = dict(depth=10, widen=1, batch_size=4, n_train=64, n_val=16,
               compute_dtype="float32", lr=0.02, lr_schedule=None, seed=3)
PORT = {"lstm": dict(modelfile="theanompi_tpu_torch.models.lstm",
                     modelclass="LSTM"),
        "wresnet": dict(modelfile="theanompi_tpu_torch.models.wresnet",
                        modelclass="WResNet")}
JAX = {"lstm": (jax_lstm.LSTM, dict(modelfile="theanompi_tpu.models.lstm",
                                    modelclass="LSTM")),
       "wresnet": (jax_wresnet.WResNet,
                   dict(modelfile="theanompi_tpu.models.wresnet",
                        modelclass="WResNet"))}
# fp32, 8 steps: the packages differ by summation order, carried on by
# momentum and the merges (measured: losses within 1.8e-7 relative,
# parameters and state within 1.5e-6)
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-5
# the merges alone: one op sequence, summation order aside
MERGE_RTOL = 1e-6


@pytest.fixture(autouse=True)
def no_dataset(tmp_path_factory, monkeypatch):
    """Every data module takes its synthetic path: TM_DATA_DIR is an
    empty directory."""
    d = tmp_path_factory.getbasetemp() / "no_data"
    d.mkdir(exist_ok=True)
    monkeypatch.setenv("TM_DATA_DIR", str(d))
    return d


# -- the merges ---------------------------------------------------------------

W = 4


def random_trees(seed=0):
    """(stacked, center, scores, route, push, mask) as numpy: a stacked
    tree of a matrix, a vector and an int leaf (a step counter)."""
    rng = np.random.default_rng(seed)
    stacked = {"w": rng.normal(size=(W, 3, 5)).astype(np.float32),
               "layers": [{"b": rng.normal(size=(W, 7)).astype(np.float32)}],
               "t": np.arange(W, dtype=np.int32) + 5}
    center = {"w": rng.normal(size=(3, 5)).astype(np.float32),
              "layers": [{"b": rng.normal(size=(7,)).astype(np.float32)}],
              "t": np.int32(2)}
    scores = rng.uniform(0.05, 0.5, W).astype(np.float32)
    route = np.array([2, 0, 0, 1], np.int32)     # two senders reach 0
    push = np.array([1, 1, 0, 1], np.float32)
    mask = np.array([1, 0, 1, 1], np.float32)
    return stacked, center, scores, route, push, mask


def to_port(tree):
    return exchange.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_trees_close(got, want):
    got = exchange.tree_map(lambda t: t.numpy(), got)
    want = jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=MERGE_RTOL, atol=1e-7)


def float_leaves(tree):
    return {k: v for k, v in tree.items() if k != "t"}


@pytest.mark.parametrize("name", [
    "elastic_pair_update", "elastic_center_merge",
    "elastic_center_merge_masked", "gossip_matrix_round", "gossip_send",
    "gossip_deliver", "gossip_merge", "broadcast_stack", "stacked_mean"])
def test_merge_matches_jax(name):
    stacked, center, scores, route, push, mask = random_trees()
    stale = random_trees(1)[0]
    port_fn = getattr(exchange, name, None) or getattr(replica_engine, name)
    jax_fn = getattr(jax_exchange, name, None) or getattr(jax_engine, name)
    args = {
        # the pair update runs on one worker's tree (slot 1)
        "elastic_pair_update": lambda: (
            jax.tree.map(lambda a: a[1], float_leaves(stacked)),
            float_leaves(center), 0.3),
        "elastic_center_merge": lambda: (float_leaves(stacked),
                                         float_leaves(center), 0.25),
        "elastic_center_merge_masked": lambda: (
            float_leaves(stacked), float_leaves(center), 0.25, mask),
        "gossip_matrix_round": lambda: (stacked, scores, route, push),
        "gossip_send": lambda: (scores, route, push),
        "gossip_deliver": lambda: (
            stacked, scores, stale,
            np.asarray(jax_exchange.gossip_send(
                jnp.asarray(scores), jnp.asarray(route),
                jnp.asarray(push))[1])),
        "gossip_merge": lambda: (
            jax.tree.map(lambda a: a[0], float_leaves(stacked)),
            np.float32(0.3), float_leaves(center), np.float32(0.2)),
        "broadcast_stack": lambda: (center, 3),
        "stacked_mean": lambda: (stacked,),
    }[name]()
    want = jax_fn(*(to_jax(a) if not isinstance(a, (float, int)) else a
                    for a in args))
    got = port_fn(*(to_port(a) if not isinstance(a, (float, int)) else a
                    for a in args))
    assert_trees_close(got, want)
    if name in ("gossip_matrix_round", "gossip_deliver"):
        # integer leaves keep their local value; scores are conserved
        assert torch.equal(got[0]["t"], torch.from_numpy(stacked["t"]))
        sent = scores.sum() if name == "gossip_matrix_round" else (
            scores.sum() + args[3].sum())
        np.testing.assert_allclose(got[1].sum().item(), sent, rtol=1e-6)


# -- trajectories against the JAX workers -------------------------------------

def write_init(directory, model, cfg, n_workers):
    """The JAX model's initial state as the checkpoint both workers
    resume from (epoch -1: the run starts at epoch 0)."""
    m = JAX[model][0](dict(cfg))
    m.build_model(n_replicas=n_workers)
    jax_save(directory, 0, {k: jax.device_get(v)
                            for k, v in m.checkpoint_trees().items()},
             {"epoch": -1, "lr": cfg["lr"]})


def trees_of(model, to_flat):
    return {g: to_flat(t) for g, t in model.checkpoint_trees().items()}


def run_both(tmp_path, monkeypatch, rule, model, cfg, n_workers, **kw):
    """The JAX worker and the port's worker from one init checkpoint;
    GoSGD's adopted scores are read from the JAX worker's
    ``_adopt_best``."""
    init = tmp_path / "init"
    write_init(init, model, cfg, n_workers)
    seen = {}
    if rule == "gosgd":
        adopt = jax_gosgd._adopt_best

        def spy(m, engine, scores):
            seen.setdefault("scores", []).append(np.asarray(scores))
            return adopt(m, engine, scores)

        monkeypatch.setattr(jax_gosgd, "_adopt_best", spy)
    jax_run = (jax_gosgd if rule == "gosgd" else jax_easgd).run
    port_run = (gosgd_worker if rule == "gosgd" else easgd_worker).run
    outs = []
    for run, devices, spec, to_flat in (
            (jax_run, list(range(n_workers)), JAX[model][1],
             lambda t: tree_to_flat(jax.device_get(t))),
            (port_run, ["cpu"] * n_workers, PORT[model], tree_to_flat)):
        d = tmp_path / ("jax" if run is jax_run else "port")
        shutil.copytree(init, d)
        out = run(devices=devices, config=cfg, n_epochs=1,
                  checkpoint_dir=str(d), resume=True, verbose=False,
                  **spec, **kw)
        outs.append({"summary": out,
                     "losses": out["recorder"].train_losses,
                     "trees": trees_of(out["model"], to_flat)})
    jx, pt = outs
    assert pt["summary"]["resumed_from"] == [-1, None]
    assert len(pt["losses"]) == len(jx["losses"]) > 0
    np.testing.assert_allclose(pt["losses"], jx["losses"], rtol=LOSS_RTOL,
                               atol=0)
    for key in ("loss", "err", "err_top5"):
        np.testing.assert_allclose(pt["summary"]["final_val"][key],
                                   jx["summary"]["final_val"][key],
                                   rtol=1e-5, atol=1e-6)
    for group in ("params", "net_state", "opt_state"):
        g, w = pt["trees"][group], jx["trees"][group]
        assert set(g) == set(w), group
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{group}{k}")
    # the summary has every key of the JAX one
    assert set(jx["summary"]) <= set(pt["summary"])
    return jx["summary"], pt["summary"], seen


def jax_routes(seed, n_rounds, n_workers, p):
    """The JAX worker's host draws: (push mask, route) per iteration."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_rounds):
        push = rng.random(n_workers) < p
        route = None
        if push.any():
            route = rng.integers(0, n_workers - 1, n_workers)
            route += route >= np.arange(n_workers)
        out.append((push, route))
    return out


@pytest.mark.parametrize("push_prob,staleness", [(1.0, 0), (0.5, 1)],
                         ids=["push_all", "stale1"])
def test_gosgd_lstm_matches_the_jax_worker(tmp_path, monkeypatch, push_prob,
                                           staleness):
    rounds = []
    merge = gosgd_worker.gossip_matrix_round
    send = gosgd_worker.gossip_send

    def spy_merge(tree, scores, route, push):
        rounds.append((push.numpy() > 0, route.numpy()))
        return merge(tree, scores, route, push)

    def spy_send(scores, route, push):
        rounds.append((push.numpy() > 0, route.numpy()))
        return send(scores, route, push)

    monkeypatch.setattr(gosgd_worker, "gossip_matrix_round", spy_merge)
    monkeypatch.setattr(gosgd_worker, "gossip_send", spy_send)
    jx, pt, seen = run_both(tmp_path, monkeypatch, "gosgd", "lstm",
                            LSTM_CFG, 4, push_prob=push_prob,
                            staleness=staleness)
    assert pt["gossip_rounds"] == jx["gossip_rounds"] == len(rounds) > 0
    want = [(push, route) for push, route in
            jax_routes(LSTM_CFG["seed"] + 101, 8, 4, push_prob)
            if route is not None]
    for (gp, gr), (wp, wr) in zip(rounds, want):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gr, wr)
    # the scores _adopt_best saw (epoch-end checkpoint, then the end)
    np.testing.assert_allclose(pt["scores"], seen["scores"][-1], rtol=1e-6)
    assert pt["best_worker"] == int(np.argmax(seen["scores"][-1]))
    np.testing.assert_allclose(sum(pt["scores"]), 1.0, rtol=1e-6)


@pytest.mark.parametrize("speeds", [None, [1.0, 0.5, 0.75, 1.0]],
                         ids=["in_step", "speeds"])
def test_easgd_lstm_matches_the_jax_worker(tmp_path, monkeypatch, speeds):
    jx, pt, _ = run_both(tmp_path, monkeypatch, "easgd", "lstm", LSTM_CFG,
                         4, speeds=speeds)
    assert pt["exchanges"] == jx["exchanges"] > 0
    if speeds is not None:
        assert pt["local_steps"] == jx["local_steps"]
        assert len(set(pt["local_steps"])) > 1


def test_easgd_wresnet_keeps_bn_state_per_replica(tmp_path, monkeypatch):
    jx, pt, _ = run_both(tmp_path, monkeypatch, "easgd", "wresnet", WRN_CFG,
                         2, tau=2, speeds=[1.0, 0.5])
    assert pt["exchanges"] == jx["exchanges"] > 0


# -- the engine and the feed --------------------------------------------------

def engine_of(cls, cfg, n_workers):
    model = cls(dict(cfg), device="cpu")
    model.build_model(n_replicas=n_workers)
    return model, replica_engine.ReplicaEngine(model, n_workers)


def test_masked_step_leaves_the_idle_replica_untouched():
    """Replica w takes rows [w*B, (w+1)*B) of the global batch; a
    masked-off replica keeps its params, BN statistics and momentum,
    and the step's loss is the active replica's alone."""
    model, eng = engine_of(WResNet, WRN_CFG, 2)
    x, y = model.data.train_batch(0)
    xs, ys = eng._split(eng.put_batch((x, y)))
    assert tuple(xs.shape) == (2, 4) + x.shape[1:]
    np.testing.assert_array_equal(xs[1].numpy(), x[4:])
    assert ys.dtype == torch.int64
    before = [t.clone() for t in eng.params + eng.net_state
              + eng.opt_state]
    loss, _ = eng.train_step((x, y), 0.02, step_mask=np.array([0, 1]))
    after = eng.params + eng.net_state + eng.opt_state
    for b, a in zip(before, after):
        assert torch.equal(a[0], b[0])          # idle: untouched
    assert all(not torch.equal(a[1], b[1]) for b, a in zip(before, after)
               if b[1].abs().sum())
    fresh = WResNet(dict(WRN_CFG), device="cpu")
    fresh.build_model(n_replicas=2)
    out = fresh.net(fresh.prep_input(torch.from_numpy(x[4:])), train=True)
    want = fresh.compute_loss(out, torch.from_numpy(y[4:]).long())
    assert loss.item() == want.item()


def test_pipelined_feed_gives_the_synchronous_trajectory():
    runs = [gosgd_worker.run(devices=["cpu"] * 2, config=dict(
        LSTM_CFG, n_train=64, loader_pipeline=depth), n_epochs=1,
        verbose=False, push_prob=0.5, **PORT["lstm"]) for depth in (0, 2)]
    assert runs[0]["recorder"].train_losses == \
        runs[1]["recorder"].train_losses
    assert runs[0]["scores"] == runs[1]["scores"]


# -- entry points and refusals ------------------------------------------------

TINY = dict(LSTM_CFG, n_train=16, n_val=16)


def test_rule_api_and_cli_run_the_async_rules(tmp_path):
    for rule in (EASGD(), GOSGD()):
        rule.init(devices=["cpu"] * 2, launch="inprocess", config=TINY,
                  n_epochs=1, verbose=False, **PORT["lstm"])
        out = rule.wait()
        assert out["n_workers"] == 2 and out["iterations"] == 2
        assert out["device"] == "cpu" and out["final_val"]
    rule = EASGD()
    rule.init(server="ignored", workers=["cpu"] * 2, launch="inprocess",
              config=TINY, n_epochs=1, verbose=False, **PORT["lstm"])
    assert rule.wait()["n_workers"] == 2
    assert main(["GOSGD", PORT["lstm"]["modelfile"], "LSTM", "--devices",
                 "cpu,cpu", "--kwargs",
                 '{"n_epochs": 1, "verbose": false, "checkpoint_dir": "%s",'
                 ' "config": {"vocab": 64, "emb_dim": 8, "hidden": 8, '
                 '"maxlen": 12, "batch_size": 4, "n_train": 16, '
                 '"compute_dtype": "float32"}}' % tmp_path]) == 0
    assert (tmp_path / "ckpt_0.npz").exists()


def test_detached_launch_runs_one_controller(tmp_path):
    rule = GOSGD()
    rule.init(devices=["cpu"] * 2, config=TINY, n_epochs=1, verbose=False,
              checkpoint_dir=str(tmp_path), **PORT["lstm"])
    assert len(rule._handle.procs) == 1
    assert rule.wait() == 0
    assert (tmp_path / "ckpt_0.npz").exists()


@pytest.mark.parametrize("rule,kwargs,error,match", [
    ("gosgd", dict(devices=["cpu"]), ValueError, ">= 2 workers"),
    ("gosgd", dict(staleness=-1), ValueError, "staleness"),
    ("easgd", dict(alpha=0.9), ValueError, "unstable"),
    ("easgd", dict(speeds=[1.0]), ValueError, "one entry per worker"),
    ("easgd", dict(speeds=[1.0, 1.5]), ValueError, r"\(0, 1\]"),
    ("easgd", dict(world_size=2, init_method="tcp://127.0.0.1:1"),
     ValueError, "one process drives one device"),
    ("gosgd", dict(world_size=2, init_method="tcp://127.0.0.1:1"),
     ValueError, "one process drives one device"),
    ("gosgd", dict(modelfile="theanompi_tpu_torch.models.llama",
                   modelclass="Llama"), TypeError, "ClassifierModel"),
])
def test_bad_runs_fail_before_the_model_is_built(monkeypatch, rule, kwargs,
                                                 error, match):
    def built(*a, **k):
        raise AssertionError("the model was built")

    monkeypatch.setattr(LSTM, "build_model", built)
    kw = dict(devices=["cpu"] * 2, config=TINY, verbose=False,
              **PORT["lstm"])
    kw.update(kwargs)
    run = (gosgd_worker if rule == "gosgd" else easgd_worker).run
    with pytest.raises(error, match=match):
        run(**kw)


@pytest.mark.parametrize("rule", ["easgd", "gosgd"])
def test_async_rules_take_trace_and_ignore_it(monkeypatch, rule):
    """As the JAX async workers do, which never read it: ``trace`` is
    not refused, and the run goes on to build the model."""
    def built(*a, **k):
        raise AssertionError("the model was built")

    monkeypatch.setattr(LSTM, "build_model", built)
    run = (gosgd_worker if rule == "gosgd" else easgd_worker).run
    with pytest.raises(AssertionError, match="the model was built"):
        run(devices=["cpu"] * 2, config=dict(TINY, trace=True),
            verbose=False, **PORT["lstm"])


def test_unstable_alpha_may_proceed_with_a_warning():
    with pytest.warns(UserWarning, match="unstable"):
        out = easgd_worker.run(devices=["cpu"] * 2, config=dict(
            TINY, allow_unstable=True), alpha=0.9, n_epochs=1,
            verbose=False, **PORT["lstm"])
    assert np.isfinite(out["final_train_loss"])


@pytest.fixture
def two_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)


def test_workers_on_several_devices_are_refused(two_cards):
    """One process runs the replicas of one device: workers on two
    cards take a process each (the launcher), and the CPU does not mix
    with a card."""
    for devices, match in (([0, 1], "one process per device"),
                           (["cpu", 0], "mix the CPU and cards")):
        for run in (easgd_worker.run, gosgd_worker.run):
            with pytest.raises(ValueError, match=match):
                run(devices=devices, config=TINY, verbose=False,
                    **PORT["lstm"])
    with pytest.raises(ValueError, match="have 2 cards"):
        easgd_worker.run(devices=[2, 2], config=TINY, **PORT["lstm"])


def test_without_a_card_the_rules_want_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for rule in (EASGD(), GOSGD()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rule.init(launch="inprocess", config=TINY, **PORT["lstm"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rule.init(devices=[0, 0], launch="inprocess", config=TINY,
                      **PORT["lstm"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["EASGD", PORT["lstm"]["modelfile"], "LSTM", "--kwargs",
                  '{"n_epochs": 1}'])
