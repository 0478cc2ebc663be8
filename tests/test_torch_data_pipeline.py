"""The port's input pipeline against the JAX package's, on the CPU.

Seeded splits at small sizes (stored images 20-32 px, a few dozen
records): the transforms under the same rng; ``ImageNet`` (JPEG) and
``RawImageNet`` (``rrc``, ``crop``, ``none``) batches through the port's
loader against the JAX ``DataLoader``'s at (workers, prefetch) (0, 1) and
(2, 3) and after a ``start_batch`` seek, on the native whole-batch crop
and on the per-sample path; the whole-batch path's fallbacks and bounds;
the ``data.fetch`` fault site under the loader's retry; the loader's
threads after an early close; a rank's rows of a node batch against the
JAX node batch; the raw writer without PIL; ``prepare_image`` against
JAX's. Data paths are bit-equal; ``prepare_image`` to 1e-7.
"""

import io
import os
import pickle
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.data import DataLoader as JaxLoader
from pytorch_distributed_tpu.data import DistributedSampler as JaxSampler
from pytorch_distributed_tpu.data import ImageNet as JaxImageNet
from pytorch_distributed_tpu.data import RawImageNet as JaxRawImageNet
from pytorch_distributed_tpu.data import transforms as JT
from pytorch_distributed_tpu.data.imagenet import write_imagenet_split as jax_write_jpeg
from pytorch_distributed_tpu.data.raw import write_imagenet_raw_split as jax_write_raw
from pytorch_distributed_tpu.train.step import prepare_image as jax_prepare_image
from pytorch_distributed_tpu_torch.data import (
    DataLoader,
    DistributedSampler,
    ImageNet,
    RawImageNet,
    image_collate,
    native,
)
from pytorch_distributed_tpu_torch.data import transforms as T
from pytorch_distributed_tpu_torch.data.imagenet import write_imagenet_split
from pytorch_distributed_tpu_torch.data.loader import PRODUCER_THREAD
from pytorch_distributed_tpu_torch.data.raw import encode_raw_record, write_imagenet_raw_split
from pytorch_distributed_tpu_torch.data.packed_record import PackedRecordWriter
from pytorch_distributed_tpu_torch.resilience import faults
from pytorch_distributed_tpu_torch.resilience.faults import FaultPlan, FaultSpec, InjectedFault
from pytorch_distributed_tpu_torch.train.step import prepare_image

STORED, CROP, BATCH = 28, 20, 4
FEEDS = [(0, 1), (2, 3)]


@pytest.fixture(autouse=True)
def _no_plan_no_sleep(monkeypatch):
    monkeypatch.setattr("time.sleep", lambda s: None)  # the retries' backoff
    yield
    faults.clear_plan()


def raw_images(n, size=STORED, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 255, (size, size, 3), np.uint8), i % 5) for i in range(n)]


def jpegs(n, seed=1):
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = rng.integers(20, 33, size=2)
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(buf, "JPEG")
        out.append((buf.getvalue(), i % 5))
    return out


def raw_split(root, n=20, split="train"):
    write_imagenet_raw_split(os.path.join(root, f"{split}.rawtprc"), raw_images(n), STORED)
    return os.fspath(root)


def jpeg_split(root, n=12, split="train"):
    write_imagenet_split(os.path.join(root, f"{split}.tprc"), jpegs(n))
    return os.fspath(root)


def datasets(kind, root, use_native=True):
    """(port dataset, JAX dataset) of one kind over the same split."""
    if kind == "jpeg":
        return (ImageNet("train", T.train_transform(16), jpeg_split(root), use_native),
                JaxImageNet("train", JT.train_transform(16), os.fspath(root)))
    raw_split(root)
    return (RawImageNet("train", os.fspath(root), CROP, kind, use_native),
            JaxRawImageNet("train", os.fspath(root), CROP, kind))


def port_loader(ds, nw=0, pf=1, batch=BATCH, **kw):
    sampler = DistributedSampler(len(ds), shuffle=True, seed=2)
    sampler.set_epoch(1)
    return DataLoader(ds, batch, sampler=sampler, num_workers=nw, prefetch=pf, seed=9, **kw)


def jax_loader(ds, batch=BATCH):
    sampler = JaxSampler(len(ds), 1, 0, shuffle=True, seed=2)
    sampler.set_epoch(1)
    return JaxLoader(ds, batch, sampler=sampler, num_workers=0, prefetch=1, seed=9)


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"image", "label"}
        assert g["image"].numpy().dtype == w["image"].dtype
        np.testing.assert_array_equal(g["image"].numpy(), w["image"])
        np.testing.assert_array_equal(g["label"].numpy(), w["label"])


def loader_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith(PRODUCER_THREAD)]


@pytest.mark.parametrize("shape", [(24, 32), (32, 20), (10, 60)])
@pytest.mark.parametrize("pipeline", ["train", "eval"])
def test_transforms_equal_jax_under_the_same_rng(shape, pipeline):
    from PIL import Image

    img = Image.fromarray(np.random.default_rng(3).integers(0, 255, shape + (3,), np.uint8))
    ours = T.train_transform(16) if pipeline == "train" else T.eval_transform(16, 20)
    theirs = JT.train_transform(16) if pipeline == "train" else JT.eval_transform(16, 20)
    for seed in range(6):  # (10, 60) takes RandomResizedCrop's center fallback
        a = ours(img, np.random.default_rng(seed))
        b = theirs(img, np.random.default_rng(seed))
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nw, pf", FEEDS)
@pytest.mark.parametrize("kind, use_native", [("jpeg", True), ("rrc", True), ("crop", True),
                                              ("crop", False), ("none", True),
                                              ("none", False)])
def test_batches_equal_the_jax_loaders(tmp_path, kind, use_native, nw, pf):
    ours, theirs = datasets(kind, tmp_path, use_native)
    assert (ours.reader._native is not None) == use_native
    loader = port_loader(ours, nw, pf)
    want = list(jax_loader(theirs))
    assert_batches_equal(list(loader), want)
    assert_batches_equal(list(loader.iter_batches(start_batch=2)), want[2:])
    if kind in ("crop", "none"):  # every batch from the native crop, or none
        assert ours.native_batches == (2 * len(loader) - 2 if use_native else 0)
    assert not loader_threads()


@pytest.mark.parametrize("nw, pf", FEEDS)
def test_a_ranks_rows_equal_the_jax_node_batchs(tmp_path, nw, pf):
    """Each of 2 local replicas fetches only its rows of a node batch of 8;
    the per-index rng makes them the JAX node batch's rows, bit for bit,
    for the native crop and rrc; the validation loader wrap-pads a
    partial node batch over 3 replicas as the JAX ``validate``'s
    ``np.resize``."""
    raw_split(tmp_path)
    for aug in ("crop", "rrc"):
        theirs = list(jax_loader(JaxRawImageNet("train", os.fspath(tmp_path), CROP, aug), 8))
        for i in range(2):
            ds = RawImageNet("train", os.fspath(tmp_path), CROP, aug)
            got = list(port_loader(ds, nw, pf, batch=8, part=(i, 2)))
            assert_batches_equal(got, [{k: v[4 * i:4 * (i + 1)] for k, v in b.items()}
                                       for b in theirs])
    val = JaxRawImageNet("train", os.fspath(tmp_path), CROP, "none")
    node = list(JaxLoader(val, 6, drop_last=False, num_workers=0, prefetch=1))
    assert [len(b["label"]) for b in node] == [6, 6, 6, 2]
    padded = [{k: np.resize(v, (len(v) + (-len(v)) % 3,) + v.shape[1:]) for k, v in b.items()}
              for b in node]
    for i in range(3):
        ds = RawImageNet("train", os.fspath(tmp_path), CROP, "none")
        got = list(DataLoader(ds, 6, drop_last=False, part=(i, 3), wrap_partial=True,
                              num_workers=nw, prefetch=pf))
        rows = [len(b["label"]) // 3 for b in padded]
        assert rows == [2, 2, 2, 1]
        assert_batches_equal(got, [{k: v[n * i:n * (i + 1)] for k, v in b.items()}
                                   for b, n in zip(padded, rows)])


def test_the_whole_batch_path_declines_where_it_does_not_apply(tmp_path):
    """rrc (PIL), a per-read CRC, a stored image smaller than the crop and
    a split of several sizes take the per-sample path; the last is latched
    and its batch equals the JAX loader's; a custom collate always runs."""
    raw_split(tmp_path)
    root = os.fspath(tmp_path)
    rng = lambda i: np.random.default_rng(i)  # noqa: E731
    assert RawImageNet("train", root, CROP, "rrc").collate_batch([0, 1], rng) is None
    assert RawImageNet("train", root, CROP, "crop", verify_crc=True).collate_batch(
        [0, 1], rng) is None
    assert RawImageNet("train", root, 64, "crop").collate_batch([0, 1], rng) is None
    assert RawImageNet("train", root, CROP, "crop", use_native=False).collate_batch(
        [0, 1], rng) is None

    mixed = tmp_path / "mixed"
    mixed.mkdir()
    images = np.random.default_rng(5)
    with PackedRecordWriter(mixed / "train.rawtprc") as w:
        for i, size in enumerate((32, 24, 32, 40)):
            w.write(encode_raw_record(images.integers(0, 255, (size, size, 3), np.uint8), i))
    ds = RawImageNet("train", os.fspath(mixed), CROP, "crop")
    assert ds.collate_batch([0, 1, 2, 3], rng) is None and ds._native_declined
    got = list(DataLoader(ds, 4, seed=5))
    want = list(JaxLoader(JaxRawImageNet("train", os.fspath(mixed), CROP, "crop"), 4,
                          num_workers=0, prefetch=1, seed=5))
    assert_batches_equal(got, want)
    assert ds.native_batches == 0

    calls = []

    def my_collate(samples):
        calls.append(len(samples))
        return dict(image_collate(samples), extra=np.ones(len(samples), np.float32))

    ds = RawImageNet("train", root, CROP, "crop")
    batch = next(iter(DataLoader(ds, 4, collate_fn=my_collate, prefetch=1)))
    assert calls == [4] and set(batch) == {"image", "label", "extra"}
    assert ds.native_batches == 0


def test_the_native_crop_checks_its_bounds(tmp_path):
    raw_split(tmp_path, n=4)
    reader = RawImageNet("train", os.fspath(tmp_path), CROP, "crop").reader._native
    with pytest.raises(IOError):
        reader.crop_batch([0], [20], [0], [False], 16, STORED, STORED)  # top + crop > h
    with pytest.raises(IOError):
        reader.crop_batch([99], [0], [0], [False], 16, STORED, STORED)  # no record 99
    with pytest.raises(native.SizeMismatch):
        reader.crop_batch([0], [0], [0], [False], 16, 64, 64)
    with pytest.raises(ValueError):
        reader.crop_batch([0, 1], [0], [0], [False], 16, STORED, STORED)  # one window short
    images, labels = reader.crop_batch([3, 0], [12, 0], [0, 12], [True, False], 16, STORED,
                                       STORED)
    stored = raw_images(4)
    np.testing.assert_array_equal(images[0], stored[3][0][12:28, 0:16][:, ::-1])
    np.testing.assert_array_equal(images[1], stored[0][0][0:16, 12:28])
    assert labels.tolist() == [3, 0]


@pytest.mark.parametrize("nw, pf", FEEDS)
def test_a_fetch_that_raises_twice_is_retried_into_the_same_batch(tmp_path, nw, pf):
    raw_split(tmp_path)
    ds = RawImageNet("train", os.fspath(tmp_path), CROP, "crop")
    want = list(port_loader(ds, nw, pf))
    plan = faults.install_plan(FaultPlan([FaultSpec("data.fetch", "raise", at=1, times=2)]))
    got = list(port_loader(ds, nw, pf))
    assert [f[:2] for f in plan.fired] == [("data.fetch", 1), ("data.fetch", 2)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert all(torch.equal(g[k], w[k]) for k in w)
    # a third failure in a row is more than the loader's 2 retries
    faults.install_plan(FaultPlan([FaultSpec("data.fetch", "raise", at=0, times=3)]))
    with pytest.raises(InjectedFault):
        list(port_loader(ds, nw, pf))
    assert not loader_threads()


class _Failing:
    """A dataset whose sample 5 raises a ValueError (a bug, not an I/O
    error); it counts the calls."""

    def __init__(self, n=12):
        self.n, self.calls = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.calls.append(i)
        if i == 5:
            raise ValueError("bad sample")
        return np.zeros((2, 2, 3), np.float32), i


@pytest.mark.parametrize("nw, pf", FEEDS)
def test_an_error_that_is_not_oserror_propagates_unretried(nw, pf):
    ds = _Failing()
    with pytest.raises(ValueError, match="bad sample"):
        list(DataLoader(ds, 4, num_workers=nw, prefetch=pf))
    assert ds.calls.count(5) == 1
    assert not loader_threads()


def test_an_early_close_leaves_no_loader_thread(tmp_path):
    raw_split(tmp_path, n=40)
    for aug in ("crop", "rrc"):
        ds = RawImageNet("train", os.fspath(tmp_path), CROP, aug)
        batches = DataLoader(ds, 4, num_workers=2, prefetch=3).iter_batches(0)
        next(batches)
        assert PRODUCER_THREAD in loader_threads()
        batches.close()
        assert not loader_threads()


def test_a_dataset_pickles_by_path_and_reads_the_same(tmp_path):
    raw_split(tmp_path)
    ds = RawImageNet("train", os.fspath(tmp_path), CROP, "crop")
    again = pickle.loads(pickle.dumps(ds))
    assert again.reader._native is not None and again.reader is not ds.reader
    a, b = list(port_loader(ds)), list(port_loader(again))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def test_the_raw_writer_needs_no_pil_at_the_stored_size(tmp_path, monkeypatch):
    """Exact-size uint8 arrays pack without PIL, byte-identical to the JAX
    writer (which imports PIL first); another size needs PIL; the crop and
    none paths read without it."""
    jax_write_raw(tmp_path / "jax.rawtprc", raw_images(6), STORED)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    write_imagenet_raw_split(tmp_path / "train.rawtprc", raw_images(6), STORED)
    assert (tmp_path / "train.rawtprc").read_bytes() == (tmp_path / "jax.rawtprc").read_bytes()
    with pytest.raises(ImportError):
        write_imagenet_raw_split(tmp_path / "other.rawtprc", raw_images(2, size=30), STORED)
    assert not (tmp_path / "other.rawtprc").exists()
    for aug in ("crop", "none"):
        batch = next(iter(DataLoader(RawImageNet("train", os.fspath(tmp_path), CROP, aug), 3)))
        assert batch["image"].shape == (3, CROP, CROP, 3)


def test_jpeg_and_image_writers_match_jax_and_pil_inputs_pack_alike(tmp_path):
    from PIL import Image

    samples = jpegs(5)
    write_imagenet_split(tmp_path / "a.tprc", samples)
    jax_write_jpeg(os.fspath(tmp_path / "b.tprc"), samples)
    assert (tmp_path / "a.tprc").read_bytes() == (tmp_path / "b.tprc").read_bytes()
    mixed = [(samples[0][0], 1), (Image.open(io.BytesIO(samples[1][0])), 2),
             (raw_images(1, size=30)[0][0], 3)]
    write_imagenet_raw_split(tmp_path / "a.rawtprc", mixed, 24)
    jax_write_raw(tmp_path / "b.rawtprc", mixed, 24)
    assert (tmp_path / "a.rawtprc").read_bytes() == (tmp_path / "b.rawtprc").read_bytes()


def test_the_reference_shaped_loaders_and_a_missing_split(tmp_path):
    raw_split(tmp_path, n=12)
    jpeg_split(tmp_path, n=12)
    sampler = DistributedSampler(12, num_replicas=2, rank=1, shuffle=False)
    for ds in (RawImageNet("train", os.fspath(tmp_path), CROP, "none"),
               ImageNet("train", T.eval_transform(16, 20), os.fspath(tmp_path))):
        loader = ds.loader(3, sampler=sampler, num_workers=2, pin_memory=True)
        assert isinstance(loader, DataLoader) and loader.num_workers == 2
        batches = list(loader)
        assert len(batches) == 2 and batches[0]["label"].tolist() == [1, 3, 0]
    with pytest.raises(FileNotFoundError, match="pack_imagenet"):
        RawImageNet("val", os.fspath(tmp_path))
    with pytest.raises(FileNotFoundError, match="pack_imagenet"):
        ImageNet("val", data_dir=os.fspath(tmp_path))
    with pytest.raises(ValueError, match="unknown aug"):
        RawImageNet("train", os.fspath(tmp_path), aug="jitter")


def test_prepare_image_equals_jaxs():
    u8 = np.random.default_rng(2).integers(0, 256, (4, 8, 8, 3)).astype(np.uint8)
    got = prepare_image(torch.from_numpy(u8)).numpy()
    want = np.asarray(jax_prepare_image(jnp.asarray(u8)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    f32 = torch.from_numpy(want.copy())
    assert prepare_image(f32) is f32
