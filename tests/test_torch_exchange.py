"""The port's gradient exchange on two gloo processes against the JAX
``allreduce_mean`` on a 2-device CPU mesh: every strategy name, the
monolithic and the bucketed layout, the 16-bit wire included (gloo
reduces bfloat16).

Each rank holds its own seeded tensors (a scalar, leading dims that do
and do not divide by the group size); both ranks must end with the
mean.  Two ranks sum one pair per element, rounded once (in bf16 on
the 16-bit wire), and halving is exact, so the two packages agree
bitwise.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from theanompi_tpu.parallel import make_mesh
from theanompi_tpu.parallel import strategies as jax_strategies
from theanompi_tpu_torch.parallel import strategies as port_strategies

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [(), (5, 3), (7,), (4, 6), (2, 2, 3)]
NAMES = sorted(port_strategies.STRATEGIES)
BUCKETS = (0, 16)     # 16 elements: the 57-element layout takes 4 buckets


def rank_inputs(rank):
    rng = np.random.default_rng(100 + rank)
    return [rng.normal(size=s).astype(np.float32) for s in SHAPES]


CHILD = """
import sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group
from theanompi_tpu_torch.parallel.strategies import STRATEGIES

rank = int(sys.argv[1])
init_group(torch.device("cpu"), rank, 2, {init!r})
rng = np.random.default_rng(100 + rank)
xs = [rng.normal(size=s).astype(np.float32) for s in {shapes!r}]
out = {{}}
for name in {names!r}:
    for be in {buckets!r}:
        ts = [torch.from_numpy(x.copy()) for x in xs]
        STRATEGIES[name](ts, bucket_elems=be)
        for i, t in enumerate(ts):
            out[f"{{name}}/{{be}}/{{i}}"] = t.numpy()
np.savez({out!r} + f"/rank{{rank}}.npz", **out)
destroy_group()
"""


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """Every strategy x bucket layout, run once on two gloo ranks."""
    import socket

    tmp = tmp_path_factory.mktemp("exchange")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp / "child.py"
    script.write_text(CHILD.format(
        root=str(ROOT), init=f"tcp://localhost:{port}", shapes=SHAPES,
        names=NAMES, buckets=BUCKETS, out=str(tmp)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def jax_mean(name, bucket_elems):
    strat = jax_strategies.get_strategy(name)
    return _jax_mean(strat.wire_dtype, strat.two_phase, bucket_elems)


@functools.lru_cache(maxsize=None)
def _jax_mean(wire_dtype, two_phase, bucket_elems):
    """One compile per distinct (wire, collective, layout): the names
    that share them share the result."""
    strat = jax_strategies.ExchangeStrategy("t", wire_dtype, two_phase)
    mesh = make_mesh(data=2, devices=jax.devices("cpu")[:2])
    stacked = [jnp.stack(xs) for xs in zip(rank_inputs(0), rank_inputs(1))]

    def body(*parts):
        tree = [p[0] for p in parts]
        return strat(tree, "data", bucket_elems=bucket_elems)

    out = jax.shard_map(body, mesh=mesh,
                        in_specs=tuple(P("data") for _ in stacked),
                        out_specs=[P() for _ in stacked],
                        check_vma=False)(*stacked)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("bucket_elems", BUCKETS)
@pytest.mark.parametrize("name", NAMES)
def test_strategy_matches_jax_on_two_ranks(port_results, name,
                                           bucket_elems):
    want = jax_mean(name, bucket_elems)
    for rank, got in enumerate(port_results):
        for i, w in enumerate(want):
            g = got[f"{name}/{bucket_elems}/{i}"]
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_array_equal(
                g, w, err_msg=f"rank {rank} tensor {i} {SHAPES[i]}")


def test_layout_matches_jax():
    """The bucket layout rule, the 64-bucket cap included."""
    from theanompi_tpu.parallel import exchange as jax_exchange
    from theanompi_tpu_torch.parallel import exchange as port_exchange

    for size, n, be in ((57, 2, 8), (57, 2, 0), (10**6, 4, 1000),
                        (100, 3, 7), (5, 2, 64), (0, 2, 8)):
        assert port_exchange.flat_layout(size, n, be) == \
            jax_exchange.flat_layout(size, n, be)
