"""The port's native ``.tmb`` loader (``theanompi_tpu_torch/native``)
against the JAX package's.

The cases of ``tests/test_native_loader.py`` run on the port's copy of
``loader.cc``, built with the system ``g++`` into the checkout's
``build/`` directory; then the port's batches are held bitwise against
the JAX ``NativeBatchLoader``'s and against the port's own prefetch
thread (the fallback without a toolchain), on ``.tmb`` files the test
writes.  No tolerance: the loader crops and flips uint8 pixels, and
the float wire subtracts the same fp32 mean in both packages."""

import numpy as np
import pytest

from theanompi_tpu.native import NativeBatchLoader as JaxLoader
from theanompi_tpu.native import load_native as jax_load_native
from theanompi_tpu_torch import native
from theanompi_tpu_torch.models.data.imagenet import (
    ImageNetData,
    write_batch_files,
)
from theanompi_tpu_torch.native import (
    NativeBatchLoader,
    load_native,
    read_tmb,
    write_tmb,
)


@pytest.fixture(scope="module", autouse=True)
def toolchain():
    if load_native() is None:
        pytest.skip("no C++ toolchain: the native build failed")


@pytest.fixture()
def tmb_files(tmp_path, rng):
    files = []
    for b in range(4):
        x = rng.integers(0, 256, (6, 16, 16, 3)).astype(np.uint8)
        y = (np.arange(6) + b * 10).astype(np.int32)
        p = tmp_path / f"b{b}.tmb"
        write_tmb(p, x, y)
        files.append(p)
    return files


def loader(files, cls=NativeBatchLoader, **kw):
    kw.setdefault("crop", 12)
    kw.setdefault("mean", np.zeros((1, 1, 3), np.float32))
    return cls(files, **kw)


def test_library_is_built_under_build_not_beside_the_source():
    path = native.library_path()
    assert path.exists() and path.parent.name == "theanompi_tpu_torch"
    assert path.parent.parent.name == "build"
    assert not list(native._SRC.parent.glob("*.so"))


class TestFormat:
    def test_roundtrip(self, tmp_path, rng):
        x = rng.integers(0, 256, (3, 8, 9, 3)).astype(np.uint8)
        y = np.array([5, 6, 7], np.int32)
        p = tmp_path / "t.tmb"
        write_tmb(p, x, y)
        xr, yr = read_tmb(p)
        np.testing.assert_array_equal(np.asarray(xr), x)
        np.testing.assert_array_equal(yr, y)

    def test_rejects_bad_magic(self, tmp_path):
        p = tmp_path / "bad.tmb"
        p.write_bytes(b"NOPE" + b"\x00" * 32)
        with pytest.raises(ValueError, match="TMB1"):
            read_tmb(p)


class TestNativeLoader:
    def test_ordered_delivery_under_permutation(self, tmb_files):
        L = loader(tmb_files, n_threads=3, depth=2)
        L.set_epoch(0, np.array([2, 0, 3, 1], np.int32))
        assert [int(L.next()[1][0]) for _ in range(4)] == [20, 0, 30, 10]
        L.close()

    def test_epoch_exhaustion_raises(self, tmb_files):
        L = loader(tmb_files[:1])
        L.set_epoch(0)
        L.next()
        with pytest.raises(StopIteration):
            L.next()
        L.close()

    def test_deterministic_per_epoch_seed(self, tmb_files):
        a = loader(tmb_files, seed=3, n_threads=4)
        b = loader(tmb_files, seed=3, n_threads=1)
        for L in (a, b):
            L.set_epoch(5)
        xa, _ = a.next()
        xb, _ = b.next()
        np.testing.assert_array_equal(xa, xb)
        a.set_epoch(6)
        xc, _ = a.next()
        assert not np.array_equal(xa, xc)
        a.close()
        b.close()

    def test_augment_subtracts_mean(self, tmp_path):
        x = np.full((2, 16, 16, 3), 200, np.uint8)  # crop/flip-invariant
        p = tmp_path / "const.tmb"
        write_tmb(p, x, np.zeros(2, np.int32))
        L = loader([p], mean=np.full((1, 1, 3), 64.0, np.float32))
        L.set_epoch(0)
        xv, _ = L.next()
        assert xv.shape == (2, 12, 12, 3)
        np.testing.assert_allclose(xv, 136.0)
        L.close()

    def test_augmentation_identical_across_producers(self, tmb_files):
        """The C++ pool and the port's ``aug_rng`` derivation give the
        same crops and flips for the same logical batch."""
        from theanompi_tpu_torch.models.data.aug_rng import crop_flip_draws

        seed, epoch, crop = 11, 3, 12
        L = loader(tmb_files, seed=seed, n_threads=2)
        perm = np.array([1, 3, 0, 2], np.int32)
        L.set_epoch(epoch, perm)
        for seq in range(4):
            x_native, y_native = L.next()
            x_raw, y_raw = read_tmb(tmb_files[perm[seq]])
            x_raw = np.asarray(x_raw, np.float32)
            n, h, w, _ = x_raw.shape
            ii, jj, flip = crop_flip_draws(seed, epoch, seq, n, h, w, crop)
            ref = np.empty((n, crop, crop, 3), np.float32)
            for k in range(n):
                img = x_raw[k, ii[k]:ii[k] + crop, jj[k]:jj[k] + crop]
                ref[k] = img[:, ::-1] if flip[k] else img
            np.testing.assert_array_equal(x_native, ref)
            np.testing.assert_array_equal(y_native, y_raw)
        L.close()

    def test_affinity_pins_workers(self, tmb_files, monkeypatch):
        monkeypatch.setenv("TM_LOADER_AFFINITY", "0")
        L = loader(tmb_files, n_threads=3)
        assert L.pinned == 3
        L.set_epoch(0)
        x, _ = L.next()
        assert x.shape[0] == 6
        L.close()

    def test_bad_affinity_spec_pins_nothing(self, tmb_files, monkeypatch):
        monkeypatch.setenv("TM_LOADER_AFFINITY", "not-cpus")
        L = loader(tmb_files, n_threads=2)
        assert L.pinned == 0
        L.set_epoch(0)
        L.next()
        L.close()

    def test_open_rejects_inconsistent_files(self, tmp_path, rng):
        a, b = tmp_path / "a.tmb", tmp_path / "b.tmb"
        write_tmb(a, rng.integers(0, 255, (2, 8, 8, 3)).astype(np.uint8),
                  np.zeros(2, np.int32))
        write_tmb(b, rng.integers(0, 255, (2, 10, 10, 3)).astype(np.uint8),
                  np.zeros(2, np.int32))
        with pytest.raises(ValueError, match="tm_loader_open failed"):
            NativeBatchLoader([a, b], crop=8,
                              mean=np.zeros((1, 1, 3), np.float32))


@pytest.mark.parametrize("raw_u8", [True, False], ids=["u8", "f32"])
def test_batches_bitwise_the_jax_loaders(tmb_files, raw_u8):
    """Both packages' C++ loaders over the same files, seed, epoch and
    permutation: the same bytes, batch by batch."""
    if jax_load_native() is None:
        pytest.skip("the JAX package's native build failed")
    mean = np.array([[[10.5, 20.25, 30.0]]], np.float32)
    perm = np.array([3, 1, 2, 0], np.int32)
    ours = loader(tmb_files, seed=7, raw_u8=raw_u8, mean=mean)
    theirs = loader(tmb_files, JaxLoader, seed=7, raw_u8=raw_u8, mean=mean)
    for L in (ours, theirs):
        L.set_epoch(2, perm)
    for _ in range(4):
        (xa, ya), (xb, yb) = ours.next(), theirs.next()
        assert xa.dtype == xb.dtype and xa.tobytes() == xb.tobytes()
        np.testing.assert_array_equal(ya, yb)
    ours.close()
    theirs.close()


def _imagenet(tmp_path, rng, monkeypatch, n=16, batch=4, size=32):
    images = rng.integers(0, 255, (n, size, size, 3)).astype(np.uint8)
    labels = rng.integers(0, 1000, n).astype(np.int32)
    write_batch_files(tmp_path, images, labels, batch, "train", fmt="tmb")
    monkeypatch.setenv("TM_DATA_DIR", str(tmp_path))
    return labels


class TestImageNetIntegration:
    def test_batch_size_mismatch_raises(self, tmp_path, rng, monkeypatch):
        _imagenet(tmp_path, rng, monkeypatch, batch=8)
        d = ImageNetData(batch_size=4, n_replicas=1, crop=24)
        with pytest.raises(ValueError, match="re-shard"):
            d.shuffle(0)

    def test_train_batch_without_shuffle_random_access(
        self, tmp_path, rng, monkeypatch
    ):
        _imagenet(tmp_path, rng, monkeypatch, n=8)
        d = ImageNetData(batch_size=4, n_replicas=1, crop=24)
        x, _ = d.train_batch(0)  # no shuffle(): random-access path
        assert x.shape == (4, 24, 24, 3)

    def test_pipeline_uses_native_loader(self, tmp_path, rng, monkeypatch):
        labels = _imagenet(tmp_path, rng, monkeypatch)
        d = ImageNetData(batch_size=4, n_replicas=1, crop=24)
        d.shuffle(0)
        assert d.feed == "native" and d._native_loader().raw_u8
        seen = []
        for i in range(d.n_batch_train):
            x, y = d.train_batch(i)
            assert x.shape == (4, 24, 24, 3) and x.dtype == np.uint8
            seen.append(tuple(y))
        assert seen == [tuple(labels[f * 4:(f + 1) * 4])
                        for f in d._file_perm]

    @pytest.mark.parametrize("u8_wire", [True, False], ids=["u8", "f32"])
    def test_native_feed_bitwise_the_thread_feed(
        self, tmp_path, rng, monkeypatch, u8_wire
    ):
        """Two epochs through the native loader and through the prefetch
        thread (``TM_NATIVE=0``, the fallback): the same batches, and
        ``feed`` says which producer served."""
        _imagenet(tmp_path, rng, monkeypatch)
        kw = dict(batch_size=4, n_replicas=1, crop=24, seed=5,
                  u8_wire=u8_wire)
        nat = ImageNetData(**kw)
        assert nat._native_loader() is not None       # built here
        monkeypatch.setenv("TM_NATIVE", "0")        # as without g++
        thr = ImageNetData(**kw)
        for epoch in (0, 1):
            nat.shuffle(epoch)
            thr.shuffle(epoch)
            assert (nat.feed, thr.feed) == ("native", "thread")
            for i in range(nat.n_batch_train):
                (xa, ya), (xb, yb) = nat.train_batch(i), thr.train_batch(i)
                assert xa.dtype == xb.dtype
                assert xa.tobytes() == xb.tobytes()
                np.testing.assert_array_equal(ya, yb)

    def test_tm_native_0_wins_over_a_built_library(self, monkeypatch):
        """``TM_NATIVE=0`` turns the loader off even after the library
        was built and bound in this process; unset, it is back."""
        monkeypatch.delenv("TM_NATIVE", raising=False)
        assert native.load_native() is not None
        monkeypatch.setenv("TM_NATIVE", "0")
        assert native.load_native() is None
        monkeypatch.delenv("TM_NATIVE")
        assert native.load_native() is not None

    def test_tm_native_0_falls_back_to_the_thread(
        self, tmp_path, rng, monkeypatch
    ):
        """A missing toolchain (here: ``load_native`` returns None) is
        the prefetch thread, as in JAX; ``feed`` records it."""
        _imagenet(tmp_path, rng, monkeypatch)
        monkeypatch.setattr(
            "theanompi_tpu_torch.native.load_native", lambda: None)
        d = ImageNetData(batch_size=4, n_replicas=1, crop=24)
        d.shuffle(0)
        assert d.feed == "thread" and d._native_loader() is None
        x, _ = d.train_batch(0)
        assert x.shape == (4, 24, 24, 3)
