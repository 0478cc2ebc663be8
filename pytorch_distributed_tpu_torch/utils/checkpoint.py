"""Sharded checkpoints and the latest/best/step artifacts
(``pytorch_distributed_tpu/utils/checkpoint.py``: ``_ShardedSave``:262,
``ManifestReader``:646, ``validate_checkpoint``:848, ``Checkpointer``:928).

The layout is the JAX package's, byte for byte, so its
``validate_checkpoint`` and ``ManifestReader`` read a directory the port
wrote and the port reads one the JAX trainers wrote:

- ``<name>.ckpt/manifest.json``: ``version`` 2, ``n_processes``, the save
  ``token``, and ``leaves``: for each ``/``-joined leaf path its
  ``dtype`` (numpy's name: ``float32``, ``bfloat16``, ``int64`` ...),
  ``shape`` and ``blocks`` (``file``, ``key`` = ``<path>#<i>``, ``start``,
  ``stop``);
- ``shard-<token>-<process:05d>.npz``: an uncompressed ``np.savez`` of
  ``__token__`` (the token's 8 bytes) and each block as its raw bytes, a
  flat ``uint8`` array; the true dtype, bf16 included, is in the manifest
  only.

A payload is a flat ``{path: leaf}`` dict, leaves being tensors, numpy
arrays, Python scalars or ``ShardedLeaf``s (``train.state.state_payload``
builds the trainers'). A replicated leaf is one block that rank 0 writes,
as JAX writes fully replicated leaves from process 0. A ``ShardedLeaf``
is this rank's part of a leaf split into equal slices along one dimension
(an FSDP shard, a pipeline stage's slice of a stacked ``[S, ...]`` leaf, a
tensor-parallel rank's heads, which in a fused projection are one slice
of each section: ``Shard.sections``): the manifest holds every part as
blocks of the global leaf (one a section), in the file
of the rank its ``Shard`` names as that part's owner, and each owner
writes its own part. So a sharded state saves the canonical global layout
with no gather, and any topology reads it back (``ManifestReader.read``
assembles the blocks; ``Shard.take`` cuts a rank's part out again).

A save has three stages, so that the step loop pays only for the first:

1. the snapshot, on the calling thread: the token (rank 0's, broadcast),
   the manifest, and a copy of every leaf into one reused host arena,
   pinned when the device is a card. The copies are queued on the current
   stream, ahead of the next step's in-place updates of the same tensors,
   and the writer waits on an event recorded after them, so the bytes are
   the state at the save however soon the next step runs (the JAX package
   copies into its arena for the same reason: its buffers are donated);
2. the write, on a thread: the token-named shard file through a tmp file
   and an atomic rename (``ckpt.shard_write`` between them), retried with
   bounded backoff;
3. ``finalize``, on the main thread of every rank at the same point: a
   barrier, rank 0's atomic replace of the manifest (the commit point,
   between ``ckpt.pre_commit`` and ``ckpt.post_commit``), a barrier, then
   the removal of this rank's shard files of earlier tokens. A crash at
   any point leaves the previous checkpoint whole: its files are named by
   its own token and stay until the new manifest is live.

Not ported: the legacy msgpack single file (``save_checkpoint``:110,
``legacy_checkpoint_step``:910), the arena's warm-up thread, and the
elastic reshard of the JAX package (``reshard/``): a restore reads the
global leaves and each rank takes its part of them.
"""

from __future__ import annotations

import dataclasses
import io
import json
import mmap
import os
import re
import shutil
import threading
import time
import warnings
import zipfile
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.parallel import distributed
from pytorch_distributed_tpu_torch.resilience.faults import fault_point
from pytorch_distributed_tpu_torch.resilience.retry import retry_call
from pytorch_distributed_tpu_torch.utils.logging import rank0_print

LATEST = "latest.ckpt"
BEST = "best.ckpt"
MANIFEST = "manifest.json"
# shard-<token>-NNNNN.npz (or the JAX package's tokenless shard-NNNNN.npz)
_SHARD_RE = re.compile(r"^shard-(?:([0-9a-f]+)-)?(\d{5})\.npz$")
STEP_CKPT_RE = re.compile(r"^step-(\d{8,})\.ckpt$")

#: torch dtypes by their numpy (ml_dtypes) name, the manifest's spelling
DTYPES = {str(d)[len("torch."):]: d for d in (
    torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.float8_e4m3fn,
    torch.float8_e5m2, torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool)}
_ALIGN = 128  # each block's offset in the snapshot arena


@dataclasses.dataclass(frozen=True)
class Shard:
    """Where one rank's tensor lies in its global leaf: part ``index`` of
    ``len(owners)`` equal slices along ``dim`` of the global ``shape``;
    ``owners[i]`` is the global rank that writes part i; ``axis`` names
    the mesh axis the parts lie on (``"data"`` for ZeRO, ``"model"`` for a
    pipeline stage or a tensor-parallel rank). ``stacked``: the rank's
    tensor is one index of the stacked dim (a pipeline stage's slice of
    an ``[S, ...]`` leaf) and lacks that dim. ``sections`` > 1: the leaf is
    viewed with ``dim`` split into ``[sections, shape[dim] / sections]``
    and the part is one block along the second of them, i.e. the same
    slice of each section (a tensor-parallel rank's heads of q, of k and
    of v in the fused ``[3·H·D, E]`` projection: sections 3)."""

    shape: Tuple[int, ...]
    dim: int
    index: int
    owners: Tuple[int, ...]
    stacked: bool = False
    axis: str = "data"
    sections: int = 1

    @property
    def parts(self) -> int:
        return len(self.owners)

    @property
    def span(self) -> int:
        """One part's length along ``dim`` within one section."""
        return self.shape[self.dim] // self.sections // self.parts

    def blocks(self, i: int) -> List[Tuple[List[int], List[int]]]:
        """``(start, stop)`` in the global leaf of each block of part
        ``i``, one a section."""
        n, whole = self.span, self.shape[self.dim] // self.sections
        out = []
        for j in range(self.sections):
            start = [0] * len(self.shape)
            stop = list(self.shape)
            start[self.dim] = j * whole + i * n
            stop[self.dim] = start[self.dim] + n
            out.append((start, stop))
        return out

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the global ``full`` (a view; a copy when
        ``sections`` > 1)."""
        if self.sections > 1:
            d = self.dim
            part = full.unflatten(d, (self.sections, -1)).narrow(
                d + 1, self.index * self.span, self.span)
            return part.flatten(d, d + 1)
        part = full.narrow(self.dim, self.index * self.span, self.span)
        return part.squeeze(self.dim) if self.stacked else part

    def block(self, local: torch.Tensor) -> torch.Tensor:
        """The rank's tensor as its block of the global leaf (of the leaf
        viewed by sections)."""
        return local.unsqueeze(self.dim) if self.stacked else local

    def pieces(self, local: torch.Tensor) -> List[torch.Tensor]:
        """The rank's tensor cut into its blocks of ``blocks`` (views)."""
        b = self.block(local)
        return [b.narrow(self.dim, j * self.span, self.span) for j in range(self.sections)]

    def assemble(self, parts: torch.Tensor) -> torch.Tensor:
        """The global leaf from every rank's ``block``, stacked in part
        order (``[parts, ...]``, an all-gather's result)."""
        d = self.dim + 1  # dim in ``parts``
        x = parts.unflatten(d, (self.sections, -1)).movedim(0, d)  # [.., sec, parts, n, ..]
        return x.flatten(self.dim, self.dim + 2)


class ShardedLeaf(NamedTuple):
    """A payload leaf of which this rank holds the part ``shard`` says."""

    local: torch.Tensor
    shard: Shard


def _shard_name(token: str, pidx: int) -> str:
    return f"shard-{token}-{pidx:05d}.npz"


def _as_leaf(x):
    """A tensor or numpy array: Python and numpy scalars become 0-dim
    arrays (int64, float64, bool), as ``np.asarray`` makes them."""
    return x if isinstance(x, (torch.Tensor, np.ndarray)) else np.asarray(x)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype)[len("torch."):]
    return leaf.dtype.name


def _raw_bytes(leaf) -> np.ndarray:
    """A leaf's bytes as a flat uint8 array (a view where it can be): on
    the host, C order."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu().reshape(-1)
        return t.view(torch.uint8).numpy()
    return np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return leaf.nbytes


class _Arena:
    """One host buffer for snapshots, reused across saves (the JAX
    ``_Arena``:203, without its warm-up thread); pinned for a card, so the
    device→host copies run asynchronously on the stream."""

    def __init__(self, pin: bool):
        self.pin = pin
        self._buf: Optional[torch.Tensor] = None

    def ensure(self, nbytes: int) -> torch.Tensor:
        if self._buf is None or self._buf.numel() < nbytes:
            self._buf = None
            self._buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=self.pin)
        return self._buf


class _ShardedSave:
    """One save in flight: the snapshot at construction, ``write`` (file
    I/O, safe on a thread) and ``finalize`` (main thread, every rank).
    ``seconds`` times each stage on the host clock: ``snapshot`` (what
    the caller waits for), ``copy`` (the writer's wait for the snapshot's
    device copies), ``write`` and ``commit``; ``nbytes`` is this rank's
    share of the leaves' bytes."""

    def __init__(self, dirpath: str, payload: Dict[str, Any],
                 arena: Optional[_Arena] = None):
        t0 = time.perf_counter()
        self.dirpath = os.fspath(dirpath)
        os.makedirs(self.dirpath, exist_ok=True)
        self.pidx = distributed.get_rank()
        world = distributed.get_world_size()
        # the save token names this save's files and lets a reader tell a
        # torn save; rank 0's, so no shared clock is needed
        token = [os.urandom(8).hex()]
        if world > 1:
            dist.broadcast_object_list(token, src=0)
        self.token = token[0]
        self.fname = _shard_name(self.token, self.pidx)

        self.manifest = {"version": 2, "n_processes": world, "leaves": {},
                         "token": self.token}
        # this rank's blocks by key: every replicated leaf on rank 0, each
        # part of a sharded leaf on its owner
        mine: Dict[str, Any] = {}
        for path, x in payload.items():
            if isinstance(x, ShardedLeaf):
                sh = x.shard
                blocks = []
                for i, owner in enumerate(sh.owners):
                    pieces = (sh.pieces(x.local) if owner == self.pidx and i == sh.index
                              else None)
                    for j, (start, stop) in enumerate(sh.blocks(i)):
                        key = f"{path}#{i * sh.sections + j}"
                        blocks.append({"file": _shard_name(self.token, owner), "key": key,
                                       "start": start, "stop": stop})
                        if pieces is not None:
                            mine[key] = pieces[j]
                self.manifest["leaves"][path] = {"dtype": _dtype_name(x.local),
                                                 "shape": list(sh.shape), "blocks": blocks}
                continue
            x = _as_leaf(x)
            self.manifest["leaves"][path] = {
                "dtype": _dtype_name(x), "shape": list(x.shape), "blocks": [{
                    "file": _shard_name(self.token, 0), "key": f"{path}#0",
                    "start": [0] * x.ndim, "stop": list(x.shape)}]}
            if self.pidx == 0:
                mine[f"{path}#0"] = x
        self.nbytes = sum(_nbytes(x) for x in mine.values())
        self.seconds = {"snapshot": 0.0, "copy": 0.0, "write": 0.0, "commit": 0.0}
        self._ready: Optional[torch.cuda.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._write_err: Optional[BaseException] = None
        self._done = False
        if arena is None:
            # blocking: the caller waits for the write, so it reads the
            # live leaves (a card's through a plain copy at write time)
            self.my_blocks = mine
            self.seconds["snapshot"] = time.perf_counter() - t0
            return
        offsets, total = [], 0
        for x in mine.values():
            total = -(-total // _ALIGN) * _ALIGN
            offsets.append(total)
            total += _nbytes(x)
        buf = arena.ensure(total)
        self.my_blocks = {}
        on_card = False
        for (key, x), off in zip(mine.items(), offsets):
            dst = buf[off:off + _nbytes(x)]
            if isinstance(x, torch.Tensor):
                src = x.detach().reshape(-1)
                on_card |= src.is_cuda
                dst.view(src.dtype).copy_(src, non_blocking=arena.pin)
            else:
                np.copyto(dst.numpy(), _raw_bytes(x))
            self.my_blocks[key] = dst
        if on_card:
            # queued ahead of the next step on this stream; the writer
            # waits on the event before it reads the arena
            self._ready = torch.cuda.Event()
            self._ready.record()
        self.seconds["snapshot"] = time.perf_counter() - t0

    def write(self) -> None:
        """Write this rank's token-named shard file. Transient I/O errors
        are retried (each attempt rewrites the tmp file from the snapshot,
        so a partial attempt is never published)."""
        t0 = time.perf_counter()
        if self._ready is not None:
            self._ready.synchronize()
        t1 = time.perf_counter()
        if self.my_blocks:
            retry_call(self._write_once, what=f"shard write {self.fname}")
        self.my_blocks = {}
        self.seconds["copy"], self.seconds["write"] = t1 - t0, time.perf_counter() - t1

    def _write_once(self) -> None:
        fname = os.path.join(self.dirpath, self.fname)
        tmp = f"{fname}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, __token__=np.frombuffer(bytes.fromhex(self.token), np.uint8),
                     **{k: _raw_bytes(v) for k, v in self.my_blocks.items()})
            f.flush()
            os.fsync(f.fileno())
        # the tmp file is whole but not published: a kill here leaves the
        # previous checkpoint restorable
        fault_point("ckpt.shard_write")
        os.replace(tmp, fname)

    def _write_guarded(self) -> None:
        try:
            self.write()
        except BaseException as e:  # raised again by finalize
            self._write_err = e

    def start(self) -> None:
        self._thread = threading.Thread(target=self._write_guarded, name="pdt-ckpt-write",
                                        daemon=True)
        self._thread.start()

    def finalize(self) -> None:
        """Join the writer, barrier, commit the manifest (rank 0), barrier,
        remove this rank's stale files. Every rank, main thread, same
        point."""
        if self._done:
            return
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._write_err is not None:
            raise self._write_err
        t0 = time.perf_counter()
        distributed.barrier()  # every data file on disk before the manifest
        if self.pidx == 0:
            mtmp = os.path.join(self.dirpath, f"{MANIFEST}.tmp.{os.getpid()}")
            with open(mtmp, "w") as f:
                json.dump(self.manifest, f)
                f.flush()
                os.fsync(f.fileno())
            # every data file landed, the manifest not replaced: a kill
            # here must restore the OLD checkpoint
            fault_point("ckpt.pre_commit")
            os.replace(mtmp, os.path.join(self.dirpath, MANIFEST))
            # the new checkpoint is live, stale files not removed: a kill
            # here must restore the NEW one
            fault_point("ckpt.post_commit")
        distributed.barrier()
        for name in os.listdir(self.dirpath):
            m = _SHARD_RE.match(name)
            stale_shard = (m is not None and int(m.group(2)) == self.pidx
                           and (m.group(1) or "") != self.token)
            stale_tmp = (f"-{self.pidx:05d}.npz.tmp." in name
                         and not name.startswith(f"shard-{self.token}-"))
            if stale_shard or stale_tmp:
                try:
                    os.remove(os.path.join(self.dirpath, name))
                except OSError:
                    pass
        self.seconds["commit"] = time.perf_counter() - t0
        self._done = True


def save_sharded(dirpath: str, payload: Dict[str, Any]) -> "_ShardedSave":
    """Write, commit and clean up one checkpoint synchronously (every rank
    calls it; rank 0 writes the replicated leaves, each owner its parts).
    Returns the save, with its ``seconds``."""
    s = _ShardedSave(dirpath, payload)
    s.write()
    s.finalize()
    return s


class _RawNpz:
    """Zero-copy reader of the uncompressed ``.npz`` files ``np.savez``
    writes (the JAX ``_RawNpz``): the zip mapped once, each member's raw
    data served as a read-only ``np.frombuffer`` view, with a fall-back to
    ``np.load`` on anything unexpected."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._members: Dict[str, tuple] = {}
        with zipfile.ZipFile(self._f) as zf:
            for info in zf.infolist():
                if info.compress_type != zipfile.ZIP_STORED:
                    raise ValueError("compressed member")
                ho = info.header_offset
                if self._mm[ho:ho + 4] != b"PK\x03\x04":
                    raise ValueError("bad local header")
                # the local header's extra field may differ from the
                # central directory's: read its lengths there
                fn = int.from_bytes(self._mm[ho + 26:ho + 28], "little")
                ex = int.from_bytes(self._mm[ho + 28:ho + 30], "little")
                name = info.filename[:-4] if info.filename.endswith(".npy") else info.filename
                self._members[name] = (ho + 30 + fn + ex, info.file_size)

    def __getitem__(self, key: str) -> np.ndarray:
        off, size = self._members[key]
        try:
            bio = io.BytesIO(self._mm[off:min(off + 4096, off + size)])
            version = np.lib.format.read_magic(bio)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(bio)
            elif version == (2, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(bio)
            else:
                raise ValueError(f"npy version {version}")
            if fortran or bio.tell() >= 4096:
                raise ValueError("unexpected npy header")
            count = int(np.prod(shape)) if shape else 1
            return np.frombuffer(self._mm, dtype=dtype, count=count,
                                 offset=off + bio.tell()).reshape(shape)
        except Exception:
            if not hasattr(self, "_np_fallback"):
                self._np_fallback = np.load(self._f.name, allow_pickle=False)
            return self._np_fallback[key]


class ManifestReader:
    """One checkpoint directory: its manifest, its shard files (mapped,
    their save token checked against the manifest's), and each leaf as a
    CPU tensor of its true dtype and shape."""

    def __init__(self, dirpath: str):
        self.dirpath = os.fspath(dirpath)
        with open(os.path.join(self.dirpath, MANIFEST)) as f:
            self.manifest = json.load(f)
        self.token = self.manifest.get("token")
        self._files: Dict[str, Any] = {}

    def leaf_paths(self) -> List[str]:
        return list(self.manifest.get("leaves", {}))

    def leaf_meta(self, path: str) -> dict:
        meta = self.manifest.get("leaves", {}).get(path)
        if meta is None:
            raise KeyError(f"checkpoint at {self.dirpath} has no leaf {path!r}")
        return meta

    def _file(self, fname: str):
        if fname not in self._files:
            fpath = os.path.join(self.dirpath, fname)
            try:
                npz = _RawNpz(fpath)
            except OSError:
                npz = retry_call(np.load, fpath, allow_pickle=False,
                                 what=f"checkpoint read {fname}")
            except Exception:
                npz = np.load(fpath, allow_pickle=False)
            if self.token is not None:
                got = bytes(np.asarray(npz["__token__"]).tobytes()).hex()
                if got != self.token:
                    raise RuntimeError(
                        f"torn checkpoint at {self.dirpath}: {fname} belongs to save {got}, "
                        f"the manifest says {self.token}; restore an older checkpoint")
            self._files[fname] = npz
        return self._files[fname]

    def _block(self, dtype: torch.dtype, b: dict) -> torch.Tensor:
        raw = np.asarray(self._file(b["file"])[b["key"]])
        with warnings.catch_warnings():  # a read-only map, never written
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(raw.reshape(-1).view(np.uint8))
        return t.view(dtype).reshape([e - s for s, e in zip(b["start"], b["stop"])])

    def read(self, path: str) -> torch.Tensor:
        """Leaf ``path`` as a CPU tensor: a read-only view of the mapped
        file where it is one block (copy it before writing to it), else
        assembled from its blocks."""
        meta = self.leaf_meta(path)
        dtype = DTYPES[meta["dtype"]]
        blocks = meta["blocks"]
        if len(blocks) == 1 and blocks[0]["stop"] == meta["shape"]:
            return self._block(dtype, blocks[0])
        out = torch.empty(meta["shape"], dtype=dtype)
        for b in blocks:
            out[tuple(slice(s, e) for s, e in zip(b["start"], b["stop"]))] = \
                self._block(dtype, b)
        return out


def peek_leaf(dirpath: str, leaf_path: str) -> torch.Tensor:
    """One single-block leaf (e.g. ``state/step``) without reading the
    others."""
    return ManifestReader(dirpath).read(leaf_path).clone()


def validate_checkpoint(dirpath: str) -> List[str]:
    """What keeps ``dirpath`` from restoring; ``[]`` means nothing: the
    manifest parses, and every shard file it names exists, opens as a zip
    (a torn write loses the central directory at its end), carries the
    manifest's token and holds every block the manifest puts in it. Reads
    no array data."""
    dirpath = os.fspath(dirpath)
    try:
        with open(os.path.join(dirpath, MANIFEST)) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        return [f"no {MANIFEST} (save died before its commit point)"]
    except (OSError, ValueError) as e:
        return [f"unreadable {MANIFEST}: {e}"]
    token = manifest.get("token")
    by_file: Dict[str, set] = {}
    for meta in manifest.get("leaves", {}).values():
        for b in meta.get("blocks", []):
            by_file.setdefault(b["file"], set()).add(b["key"])
    problems = []
    for fname, keys in sorted(by_file.items()):
        try:
            with np.load(os.path.join(dirpath, fname), allow_pickle=False) as npz:
                members = set(npz.files)
                if token is not None:
                    got = bytes(np.asarray(npz["__token__"]).tobytes()).hex()
                    if got != token:
                        problems.append(f"{fname}: token {got} != manifest {token} "
                                        "(torn save)")
                        continue
        except FileNotFoundError:
            problems.append(f"{fname}: missing shard file")
            continue
        except Exception as e:
            problems.append(f"{fname}: unreadable ({e})")
            continue
        lost = keys - members
        if lost:
            problems.append(f"{fname}: {len(lost)} manifest block(s) absent "
                            f"(e.g. {sorted(lost)[0]!r})")
    return problems


class Checkpointer:
    """The ``latest``/``best``/``step-NNNNNNNN`` checkpoints of a save
    directory, for a state on ``device`` (CUDA unless ``device="cpu"``).

    ``block=False`` saves pay only for the snapshot: the file is written
    on a thread and committed at ``wait()``, which the trainers call at
    points every rank reaches in the same order (the next save, epoch
    end, suspend, rollback). Until then the previous checkpoint stays
    whole. Step checkpoints keep the newest ``keep_last``, removed only
    after the new one is committed."""

    def __init__(self, save_dir: str, device=None):
        self.save_dir = os.fspath(save_dir)
        self.device = resolve_device(device)
        self._pending: Optional[_ShardedSave] = None
        self._arena = _Arena(pin=self.device.type == "cuda")
        self._step_keep: Optional[int] = None  # retention, applied at wait()
        #: the last committed save: its path, ``bytes`` and stage seconds
        self.last_save: Optional[dict] = None

    def _path(self, name: str) -> str:
        return os.path.join(self.save_dir, name)

    @property
    def latest_path(self) -> str:
        return self._path(LATEST)

    @property
    def best_path(self) -> str:
        return self._path(BEST)

    def has_latest(self) -> bool:
        """A committed ``latest.ckpt`` (a directory without its manifest is
        a save that died before its commit point)."""
        return os.path.exists(os.path.join(self.latest_path, MANIFEST))

    def _save(self, path: str, payload: Dict[str, Any], block: bool) -> None:
        self.wait()  # one save in flight; commit the previous one
        if block:
            self._record(save_sharded(path, payload))
        else:
            s = _ShardedSave(path, payload, arena=self._arena)
            s.start()
            self._pending = s

    def save_latest(self, payload: Dict[str, Any], block: bool = True) -> None:
        """``latest.ckpt`` on every rank. The suspend path blocks: it
        yields next, after the commit."""
        self._save(self.latest_path, payload, block)

    def save_best(self, payload: Dict[str, Any], block: bool = True) -> None:
        self._save(self.best_path, payload, block)

    def step_path(self, step: int) -> str:
        return self._path(f"step-{int(step):08d}.ckpt")

    def step_checkpoints(self) -> List[tuple]:
        """``(step, path)`` of the committed step checkpoints, oldest
        first by the number in the name."""
        out = []
        if not os.path.isdir(self.save_dir):
            return out
        for name in os.listdir(self.save_dir):
            m = STEP_CKPT_RE.match(name)
            p = os.path.join(self.save_dir, name)
            if m and os.path.exists(os.path.join(p, MANIFEST)):
                out.append((int(m.group(1)), p))
        return sorted(out)

    def save_step(self, payload: Dict[str, Any], step: int, keep_last: int = 3,
                  block: bool = False) -> None:
        """``step-<step>.ckpt``; once it is committed, the committed step
        checkpoints beyond the newest ``keep_last`` go."""
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self._save(self.step_path(step), payload, block)
        self._step_keep = keep_last
        if block:
            self._gc_steps()

    def _gc_steps(self) -> None:
        """Remove committed step checkpoints beyond the newest
        ``_step_keep``, and uncommitted step directories older than the
        newest committed one (debris of crashed saves). Rank 0, after the
        commit."""
        keep, self._step_keep = self._step_keep, None
        if keep is None or not distributed.is_primary():
            return
        done = self.step_checkpoints()
        for _step, path in done[:-keep] if len(done) > keep else []:
            shutil.rmtree(path, ignore_errors=True)
        if done:
            newest = done[-1][0]
            for name in os.listdir(self.save_dir):
                m = STEP_CKPT_RE.match(name)
                p = os.path.join(self.save_dir, name)
                if (m and int(m.group(1)) < newest
                        and not os.path.exists(os.path.join(p, MANIFEST))):
                    shutil.rmtree(p, ignore_errors=True)

    def restorable_paths(self) -> List[str]:
        """Every checkpoint that passes ``validate_checkpoint``, newest
        first by its saved ``state/step`` (a tie goes to ``latest.ckpt``);
        a damaged one is reported and skipped, so a run whose newest save
        was torn resumes from the newest whole one."""
        candidates = [p for _s, p in self.step_checkpoints()]
        if self.has_latest():
            candidates.append(self.latest_path)
        ranked = []  # (step, tie rank, path): later candidates win ties
        for rank, p in enumerate(candidates):
            try:
                s = int(peek_leaf(p, "state/step"))
            except Exception as e:
                rank0_print(f"checkpoint fallback: discarding {p} (unreadable step leaf: {e})")
                continue
            ranked.append((s, rank, p))
        out = []
        for s, _rank, p in sorted(ranked, reverse=True):
            problems = validate_checkpoint(p)
            if problems:
                rank0_print(f"checkpoint fallback: discarding {p} at step {s}: "
                            + "; ".join(problems))
                continue
            out.append(p)
        return out

    def newest_restorable(self) -> Optional[str]:
        paths = self.restorable_paths()
        return paths[0] if paths else None

    def wait(self) -> None:
        """Join the pending write and commit it (barriers, manifest, stale
        files), then apply the step retention. Every rank, same point."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.finalize()
            self._record(pending)
        self._gc_steps()

    def _record(self, save: _ShardedSave) -> None:
        self.last_save = dict(save.seconds, path=save.dirpath, bytes=save.nbytes)
