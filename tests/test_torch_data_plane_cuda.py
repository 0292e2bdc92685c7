"""The data plane on the card (marked ``cuda``; each test skips where no
CUDA device is present): pinned staging buffers, the copy stream and
its event, and the allocator's view of tensors made on one stream and
read on another.  The file imports no jax, so it runs where the card
is: ``python3 -m pytest --noconftest tests/test_torch_data_plane_cuda.py``.
"""

import numpy as np
import pytest
import torch

from theanompi_tpu_torch.data import HostStager, StreamingLoader

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_staged_batches_are_bitwise_the_host_rows(dev):
    """Each rank's rows of float32, uint8 and int32 (staged as int64)
    arrays, through the pinned ring several times over."""
    rng = np.random.default_rng(0)
    for rank in (0, 1):
        st = HostStager(dev, 4, rank=rank, dtypes=(None, None, torch.int64),
                        slots=2)
        for _ in range(5):
            x = rng.normal(size=(8, 5, 5, 3)).astype(np.float32)
            u = rng.integers(0, 256, (8, 7, 3), dtype=np.uint8)
            y = rng.integers(0, 1000, 8).astype(np.int32)
            staged = st.stage((x, u, y))
            assert staged.event is not None
            sx, su, sy = staged.wait()
            assert sx.device == dev and sy.dtype == torch.int64
            lo = 4 * rank
            assert torch.equal(sx.cpu(), torch.from_numpy(x[lo:lo + 4]))
            assert torch.equal(su.cpu(), torch.from_numpy(u[lo:lo + 4]))
            assert sy.cpu().tolist() == y[lo:lo + 4].tolist()
        assert all(b.is_pinned() for bufs in st._bufs for b in bufs)


def test_depth_two_ring_under_a_slow_consumer_keeps_every_batch(dev):
    """50 batches through a depth-2 ring (3 pinned slots), each read
    only after ``torch.cuda._sleep`` on the compute stream and then
    dropped: a pinned slot refilled before its copy finished, or a
    block the allocator handed out while the compute stream still read
    it, would leave a batch that is not its host rows."""
    n, rows = 50, 64
    host = [np.full((rows, 1024), i, np.float32)
            + np.arange(1024, dtype=np.float32) for i in range(n)]
    labels = [np.full(rows, i, np.int32) for i in range(n)]
    st = HostStager(dev, rows, dtypes=(None, torch.int64), slots=3)
    ld = StreamingLoader(lambda i: (host[i], labels[i]), st.stage,
                         n_batches=n, depth=2, device=dev)
    copies = []
    try:
        for i in range(n):
            x, y = ld.next(i).wait()
            torch.cuda._sleep(2_000_000)      # ~1 ms of a busy stream
            copies.append((x * 1.0, y + 0))
            del x, y
    finally:
        ld.stop()
    torch.cuda.synchronize()
    for i, (x, y) in enumerate(copies):
        assert torch.equal(x.cpu(), torch.from_numpy(host[i])), i
        assert torch.equal(y.cpu(), torch.from_numpy(labels[i]).long()), i
    assert ld.staged + ld.starved == n and ld.starved <= 1
