"""The TPRC container and its readers in the port against the JAX package.

- The same records give byte-identical files from both writers, with and
  without the CRC table, and each package's readers (native and Python)
  read the other's files record for record.
- The port's native and Python readers agree, and a reader pickles by its
  path (a dataset crossing to a spawned rank reopens its file).
- Damaged files (a CRC mismatch, a truncated payload or table, junk, an
  empty file, a corrupt record count) raise the JAX package's exception
  types, reader for reader; the one difference: the JAX Python reader
  overflows on a record count larger than the file can hold, where the
  port's raises the ``ValueError`` of a truncated table, as its C++ core
  refuses it.
- A writer that raises publishes nothing; the native library is named by
  its source's hash and a failed build raises.
- ``tools/pack_imagenet.py`` writes files byte-identical to the JAX
  package's ``scripts/pack_imagenet.py`` (run as a subprocess) in both
  modes.

Data paths are bit-equal: no tolerance.
"""

import filecmp
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pytorch_distributed_tpu.data import packed_record as jpr
from pytorch_distributed_tpu_torch.data import native
from pytorch_distributed_tpu_torch.data import packed_record as tpr
from pytorch_distributed_tpu_torch.tools import pack_imagenet

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": jpr, "port": tpr}


def records():
    rng = np.random.default_rng(0)
    return [rng.bytes(int(n)) for n in rng.integers(1, 3000, size=40)] + [b""]


def write(pkg: str, path, with_crc: bool = True, recs=None) -> str:
    path = os.fspath(path)
    with PACKAGES[pkg].PackedRecordWriter(path, with_crc=with_crc) as w:
        w.write_all(records() if recs is None else recs)
    return path


@pytest.mark.parametrize("with_crc", [True, False])
def test_both_writers_write_identical_files(tmp_path, with_crc):
    a = write("jax", tmp_path / "a.tprc", with_crc)
    b = write("port", tmp_path / "b.tprc", with_crc)
    assert Path(a).read_bytes() == Path(b).read_bytes()
    assert sorted(os.listdir(tmp_path)) == ["a.tprc", "b.tprc"]  # no temporary left


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("with_crc", [True, False])
def test_each_package_reads_the_others_files(tmp_path, writer, reader, use_native, with_crc):
    path = write(writer, tmp_path / "x.tprc", with_crc)
    want = records()
    with PACKAGES[reader].PackedRecordReader(path, use_native=use_native) as r:
        assert len(r) == len(want)
        assert [r.read(i) for i in range(len(r))] == want
        assert r.read_batch([3, 1, 40, 1]) == [want[3], want[1], want[40], want[1]]
        r.verify_all()


def test_native_and_python_readers_agree(tmp_path):
    path = write("port", tmp_path / "x.tprc")
    idx = np.random.default_rng(1).permutation(41)
    with tpr.PackedRecordReader(path, use_native=True) as n, \
            tpr.PackedRecordReader(path, use_native=False) as p:
        assert n._native is not None and p._native is None
        assert [n._native.size(i) for i in range(41)] == [len(r) for r in records()]
        for verify in (True, False):
            assert n.read_batch(idx, verify) == p.read_batch(idx, verify)
            assert [n.read(int(i), verify) for i in idx] == [p.read(int(i), verify) for i in idx]
        for r in (n, p):
            with pytest.raises(IndexError):
                r.read(41)


@pytest.mark.parametrize("use_native", [True, False])
def test_a_reader_pickles_by_its_path(tmp_path, use_native):
    path = write("port", tmp_path / "x.tprc")
    r = tpr.PackedRecordReader(path, use_native=use_native)
    blob = pickle.dumps(r)
    assert len(blob) < 500  # the path and the reader kind, not the file's tables
    r.close()
    with pickle.loads(blob) as again:
        assert (again._native is not None) == use_native
        assert [again.read(i) for i in range(len(again))] == records()


def damage(path: str, kind: str) -> str:
    data = Path(path).read_bytes()
    if kind == "crc":  # the last payload byte flipped
        data = data[:-1] + bytes([data[-1] ^ 0xFF])
    elif kind == "truncated_payload":
        data = data[:-100]
    elif kind == "truncated_table":
        data = data[:60]
    elif kind == "junk":
        data = np.random.default_rng(2).bytes(len(data))
    elif kind == "empty":
        data = b""
    elif kind == "count":  # n far beyond what the file holds
        data = data[:8] + (2 ** 60).to_bytes(8, "little") + data[16:]
    Path(path).write_bytes(data)
    return path


def outcome(pkg: str, path: str, use_native: bool):
    """The exception type reading every record (CRC checked) raises, or
    None."""
    try:
        with PACKAGES[pkg].PackedRecordReader(path, use_native=use_native) as r:
            for i in range(len(r)):
                r.read(i)
    except Exception as e:  # the type is what is compared
        return type(e)
    return None


@pytest.mark.parametrize("kind", ["crc", "truncated_payload", "truncated_table", "junk",
                                  "empty", "count"])
@pytest.mark.parametrize("use_native", [True, False])
def test_damaged_files_raise_the_jax_packages_exceptions(tmp_path, monkeypatch, kind,
                                                         use_native):
    # the readers' bounded retry would sleep between attempts at a bad record
    monkeypatch.setattr("time.sleep", lambda s: None)
    # a file of more records than the corrupt ones, so a cut lands in the payload
    recs = [bytes([i]) * 300 for i in range(8)]
    path = damage(write("port", tmp_path / "x.tprc", recs=recs), kind)
    got, want = outcome("port", path, use_native), outcome("jax", path, use_native)
    assert got is not None
    if kind == "count" and not use_native:
        assert want is OverflowError and got is ValueError
    else:
        assert got is want
    if kind == "crc":  # the corruption is invisible without the CRC
        with tpr.PackedRecordReader(path, use_native=use_native) as r:
            assert r.read(7, verify_crc=False) == bytes([7]) * 299 + bytes([7 ^ 0xFF])


def test_verify_all_finds_a_corrupt_record(tmp_path, monkeypatch):
    monkeypatch.setattr("time.sleep", lambda s: None)
    path = damage(write("port", tmp_path / "x.tprc", recs=[b"a" * 100, b"b" * 100]), "crc")
    with tpr.PackedRecordReader(path) as r:
        with pytest.raises(IOError):
            r.verify_all()


def test_a_writer_that_raises_publishes_nothing(tmp_path):
    path = tmp_path / "crash.tprc"
    with pytest.raises(RuntimeError):
        with tpr.PackedRecordWriter(path) as w:
            w.write(b"one")
            raise RuntimeError("source iterator died")
    assert list(os.listdir(tmp_path)) == []
    w = tpr.PackedRecordWriter(tmp_path / "x.tprc")
    w.close()
    with pytest.raises(ValueError):
        w.write(b"late")


def test_the_library_is_named_by_its_sources_hash(tmp_path, monkeypatch):
    src = tmp_path / "recordio.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    first = native.library_path()
    assert first.name.startswith("librecordio-") and first.parent == tmp_path / "build"
    src.write_bytes(src.read_bytes() + b"\n// an edit\n")
    assert native.library_path() != first
    built = native.build()
    assert built == native.library_path() and built.exists()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [built.name]


def test_a_failed_build_raises_and_no_compiler_takes_the_python_reader(tmp_path, monkeypatch):
    path = write("port", tmp_path / "x.tprc")
    src = tmp_path / "recordio.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    with pytest.raises(RuntimeError, match="recordio.cpp failed"):
        tpr.PackedRecordReader(path)
    monkeypatch.setattr(native, "find_compiler", lambda: None)
    assert not native.available()
    with tpr.PackedRecordReader(path) as r:
        assert r._native is None and r.read(0) == records()[0]
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tpr.PackedRecordReader(path, use_native=True)


def image_folder(root: Path) -> Path:
    from PIL import Image

    rng = np.random.default_rng(4)
    for cls in ("b", "a"):
        (root / cls).mkdir(parents=True)
        for k in range(3):
            h, w = rng.integers(20, 40, size=2)
            Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
                root / cls / f"img{k}.png")
        (root / cls / "notes.txt").write_text("not an image")
    return root


@pytest.mark.parametrize("mode", [[], ["--raw", "--image-size", "24"]])
def test_the_pack_tool_writes_the_jax_scripts_files(tmp_path, mode):
    src = image_folder(tmp_path / "src")
    subprocess.run([sys.executable, str(REPO / "scripts" / "pack_imagenet.py"), str(src),
                    str(tmp_path / "jax"), "--split", "val", *mode], check=True, cwd=REPO,
                   capture_output=True, timeout=300)
    path = pack_imagenet.main([str(src), str(tmp_path / "port"), "--split", "val", *mode])
    name = "val.rawtprc" if mode else "val.tprc"
    assert Path(path) == tmp_path / "port" / name
    assert filecmp.cmp(tmp_path / "jax" / name, path, shallow=False)
    with tpr.PackedRecordReader(path) as r:
        assert len(r) == 6
