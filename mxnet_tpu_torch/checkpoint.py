"""Checkpoints: atomic files and the single-process checkpoint manager.

Counterpart of ``mxnet_tpu/checkpoint.py``, whose on-disk format it
writes and reads byte for byte, so each package resumes from the
other's checkpoints::

    <dir>/ckpt-<step>.tmp/            written first
        shard-00000.bin               the pickled snapshot
        shard-00000.ok                {"sha256", "bytes", "step"}
        COMMIT                        the manifest, once the .ok exists
    <dir>/ckpt-<step>/                the .tmp directory renamed

A checkpoint exists only once ``COMMIT`` sits in a renamed directory; a
crash at any earlier point leaves a torn ``.tmp`` directory that
restore ignores and retires.  Restore takes the newest committed
checkpoint whose checksum holds, falling back past a corrupt one.

A snapshot (a shard) is a pickle of numpy arrays and Python builtins
only, so the JAX package unpickles the port's shards without ``torch``
and the port the JAX package's without ``jax``: the step, epoch and
batch, the parameters (``arg_params``/``aux_params``), the optimizer
payload (``Module._optimizer_states_to_host``), the iterator position
(``state_dict``).  Randomness is each package's own: the port writes
``"rng": None`` and keeps its step-key chain under ``torch_rng`` (and
the fused step's generators under the payload's ``torch_streams``),
which the JAX package ignores; the JAX package's threefry key (``rng``)
and its fused step's ``fused_key`` cannot be reproduced here and are
ignored, with a warning.

``CheckpointManager.save`` takes the snapshot on the training thread as
device copies (``get_params`` clones, the fused state's clones) and a
CUDA event after them, without synchronizing the device; a background
writer thread waits on that event on a stream of its own, moves the
copies to the host, pickles, checksums, writes and commits.  The
multi-rank parts of the JAX manager (the kvstore barrier, the shards of
other ranks, elastic rollback) are not ported yet.  ``publish_params``
writes a params-only checkpoint (the draft LM's, for the ``draft_lm``
proposer) and ``load_latest_params`` reads the newest one of either
package.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import queue
import shutil
import signal
import tempfile
import threading
import time
from collections import namedtuple
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import random as _random
from .base import MXNetError, not_ported
from .ndarray import HostBF16, NDArray, tensor_to_host

__all__ = [
    "CheckpointManager", "atomic_save", "atomic_write_bytes",
    "list_checkpoints", "read_commit", "verify_checkpoint", "load_shard",
    "publish_params", "load_latest_params", "CkptInfo", "FORMAT",
    "FUSED_STATES_FORMAT", "dumps", "loads",
]

FORMAT = "mxnet_tpu-ckpt-v1"
# the fused step's optimizer-states file (``Module.save_optimizer_states``)
FUSED_STATES_FORMAT = "mxnet_tpu-fused-states-v1"
_COMMIT_FILE = "COMMIT"
_DIR_PREFIX = "ckpt-"
_TMP_SUFFIX = ".tmp"

CkptInfo = namedtuple("CkptInfo", ["step", "path", "committed"])


# ---------------------------------------------------------------------------
# atomic file primitives (shared with model.save_checkpoint)
# ---------------------------------------------------------------------------

def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # a filesystem that refuses O_RDONLY on directories
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_save(path: str, writer) -> None:
    """``writer(tmp_path)`` makes the file, which is fsynced and renamed
    over ``path``: a crash at any point leaves the old file or the new
    one, never a part of one."""
    tmp = f"{path}.part.{os.getpid()}"
    try:
        writer(tmp)
        _fsync_file(tmp)
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(os.path.abspath(path)))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_bytes(path: str, data: bytes) -> None:
    def write(tmp):
        with open(tmp, "wb") as f:
            f.write(data)

    atomic_save(path, write)


# ---------------------------------------------------------------------------
# the MXNET_CKPT_* variables (declared in ``config``); each fails loudly
# when it does not parse
# ---------------------------------------------------------------------------

def _env(name: str, override=None, minimum=None):
    """The value of ``name`` (``override`` when given), raising
    ``MXNetError`` on a value that does not parse or is below
    ``minimum``."""
    from .config import describe

    _, default, dtype, doc = describe(name)
    if override is not None:
        val = override
    else:
        raw = os.environ.get(name)
        if raw is None:
            return default
        try:
            val = dtype(raw)
        except (TypeError, ValueError):
            raise MXNetError(f"invalid {name}={raw!r}: expected "
                             f"{dtype.__name__}. {doc}") from None
    if minimum is not None and val is not None and val < minimum:
        raise MXNetError(f"invalid {name}={val!r}: must be >= {minimum}")
    return val


_CRASH_POINTS = ("mid_shard", "before_commit")


class _CrashInjector:
    """``MXNET_CKPT_CRASH``: ``mid_shard[:n]`` exits (code 9) halfway
    through writing the shard of the n-th save, ``before_commit[:n]``
    after its shard marker, before ``COMMIT``.  Checked at construction,
    so a typo fails instead of never firing."""

    def __init__(self, spec: Optional[str]):
        self.point = None
        self.nth = 1
        if not spec:
            return
        parts = spec.split(":")
        if parts[0] not in _CRASH_POINTS or len(parts) > 2 or \
                (len(parts) == 2 and not parts[1].isdigit()):
            raise MXNetError(
                f"invalid MXNET_CKPT_CRASH={spec!r}: expected one of "
                f"{_CRASH_POINTS} with an optional ':<nth-save>' suffix")
        self.point = parts[0]
        if len(parts) == 2:
            self.nth = int(parts[1])

    def armed(self, point: str, save_count: int) -> bool:
        return self.point == point and save_count == self.nth

    def fire(self):
        logging.warning("[ckpt] MXNET_CKPT_CRASH=%s firing: exiting hard",
                        self.point)
        os._exit(9)


# ---------------------------------------------------------------------------
# scanning and verification
# ---------------------------------------------------------------------------

def _parse_step(name: str) -> Optional[int]:
    if not name.startswith(_DIR_PREFIX):
        return None
    stem = name[len(_DIR_PREFIX):]
    if stem.endswith(_TMP_SUFFIX):
        stem = stem[:-len(_TMP_SUFFIX)]
    return int(stem) if stem.isdigit() else None


def list_checkpoints(directory: str) -> List[CkptInfo]:
    """Every checkpoint directory under ``directory``, by step;
    ``committed`` only for a renamed directory holding ``COMMIT``."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        step = _parse_step(name)
        path = os.path.join(directory, name)
        if step is None or not os.path.isdir(path):
            continue
        committed = (not name.endswith(_TMP_SUFFIX)
                     and os.path.isfile(os.path.join(path, _COMMIT_FILE)))
        out.append(CkptInfo(step, path, committed))
    out.sort(key=lambda i: (i.step, i.committed))
    return out


def read_commit(path: str) -> Dict[str, Any]:
    """The ``COMMIT`` manifest of the checkpoint at ``path``."""
    marker = os.path.join(path, _COMMIT_FILE)
    if not os.path.isfile(marker):
        raise MXNetError(f"checkpoint {path!r} has no COMMIT marker "
                         "(torn/uncommitted)")
    try:
        with open(marker) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as exc:
        raise MXNetError(f"corrupt COMMIT marker in {path!r}: {exc}")
    if manifest.get("format") != FORMAT or "shards" not in manifest:
        raise MXNetError(f"unrecognized COMMIT manifest in {path!r}")
    return manifest


def _shard_name(rank: int) -> str:
    return f"shard-{rank:05d}.bin"


def verify_checkpoint(path: str) -> List[str]:
    """Every shard's size and sha256 against the manifest → the problems
    found (empty: clean)."""
    problems: List[str] = []
    try:
        manifest = read_commit(path)
    except MXNetError as exc:
        return [str(exc)]
    for rank_key, meta in sorted(manifest["shards"].items()):
        shard = os.path.join(path, _shard_name(int(rank_key)))
        try:
            with open(shard, "rb") as f:
                blob = f.read()
        except OSError as exc:
            problems.append(f"missing shard {shard!r}: {exc}")
            continue
        if len(blob) != meta["bytes"]:
            problems.append(f"shard {shard!r}: size {len(blob)} != "
                            f"manifest {meta['bytes']}")
        elif hashlib.sha256(blob).hexdigest() != meta["sha256"]:
            problems.append(f"shard {shard!r}: sha256 mismatch")
    return problems


def load_shard(path: str, rank: int) -> Dict[str, Any]:
    """The snapshot of ``rank`` in the committed checkpoint at ``path``,
    its checksum verified (shard 0 when the checkpoint has none for
    ``rank``: every shard holds the whole parameters)."""
    manifest = read_commit(path)
    shards = manifest["shards"]
    key = f"{rank:05d}"
    if key not in shards:
        fallback = sorted(shards)[0]
        logging.warning("[ckpt] %s has no shard for rank %d "
                        "(saved with %d shards); loading shard %s",
                        path, rank, len(shards), fallback)
        key = fallback
    shard = os.path.join(path, _shard_name(int(key)))
    try:
        with open(shard, "rb") as f:
            blob = f.read()
    except OSError as exc:
        raise MXNetError(f"missing shard in {path!r}: {exc}")
    if hashlib.sha256(blob).hexdigest() != shards[key]["sha256"]:
        raise MXNetError(f"checksum mismatch in {shard!r} "
                         "(corrupt checkpoint)")
    state = loads(blob)
    if not isinstance(state, dict) or state.get("format") != FORMAT:
        raise MXNetError(f"unrecognized snapshot format in {shard!r}")
    return state


# ---------------------------------------------------------------------------
# weight publish / load: a committed params-only checkpoint
# ---------------------------------------------------------------------------

def publish_params(directory: str, params: Dict[str, Any], step: int,
                   aux_params: Optional[Dict[str, Any]] = None) -> str:
    """Write a committed params-only checkpoint ``ckpt-<step>`` under
    ``directory`` in the format ``CheckpointManager`` commits (one
    checksummed shard and the ``COMMIT`` manifest;
    ``mxnet_tpu/checkpoint.py:314-354``), atomically: a reader sees the
    old newest checkpoint or the new one.  ``params`` may hold NDArrays,
    tensors or numpy arrays.  Returns the committed path; an existing
    step raises."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"{_DIR_PREFIX}{int(step):012d}")
    if os.path.isdir(final):
        raise MXNetError(f"checkpoint step {step} already committed at "
                         f"{final}; publish a higher step")
    tmp = final + _TMP_SUFFIX
    os.makedirs(tmp, exist_ok=True)
    snap = {
        "format": FORMAT, "step": int(step), "epoch": 0, "nbatch": 0,
        "rank": 0, "num_shards": 1, "reason": "publish",
        "wall_time": time.time(),
        "arg_params": dict(params),
        "aux_params": dict(aux_params or {}),
        "optimizer": None, "rng": None, "iter_state": None,
    }
    blob = dumps(snap)
    sha = hashlib.sha256(blob).hexdigest()
    atomic_write_bytes(os.path.join(tmp, _shard_name(0)), blob)
    manifest = {"format": FORMAT, "step": int(step), "num_shards": 1,
                "shards": {"00000": {"sha256": sha, "bytes": len(blob),
                                     "step": int(step)}},
                "wall_time": time.time()}
    atomic_write_bytes(os.path.join(tmp, _COMMIT_FILE),
                       json.dumps(manifest, indent=1).encode())
    _fsync_dir(tmp)
    os.rename(tmp, final)
    _fsync_dir(directory)
    return final


def load_latest_params(path: str):
    """``(params, step, checkpoint path)`` of the newest committed,
    checksum-clean checkpoint at ``path`` (one checkpoint directory, or
    a root of ``ckpt-*`` directories), arg and aux parameters merged
    into one dict of host arrays (bfloat16 ones as ``HostBF16``)
    (``mxnet_tpu/checkpoint.py:357-396``).  Training checkpoints load
    too, their optimizer and iterator payloads ignored; a corrupt newest
    checkpoint falls back to the one before; none usable raises."""
    if os.path.isfile(os.path.join(path, _COMMIT_FILE)):
        candidates = [path]
    else:
        candidates = [i.path for i in reversed(list_checkpoints(path))
                      if i.committed]
    last_err: Optional[MXNetError] = None
    for cand in candidates:
        try:
            state = load_shard(cand, 0)
        except MXNetError as exc:
            logging.warning("[ckpt] %s unusable for weight load (%s); "
                            "trying the previous committed checkpoint",
                            cand, exc)
            last_err = exc
            continue
        params = dict(state.get("arg_params") or {})
        params.update(state.get("aux_params") or {})
        if not params:
            last_err = MXNetError(f"checkpoint {cand} has no parameters")
            continue
        return params, int(state["step"]), cand
    detail = f": {last_err}" if last_err is not None else ""
    raise MXNetError(
        f"no committed, checksum-clean checkpoint under {path!r}{detail}")


# ---------------------------------------------------------------------------
# host trees
# ---------------------------------------------------------------------------

def to_host_tree(obj):
    """``obj`` (dicts, lists, tuples, NDArrays, tensors, builtins) with
    every array as a host numpy array, a bfloat16 one as a ``HostBF16``
    (its bits; ``dumps`` pickles it as an ``ml_dtypes`` array)."""
    if isinstance(obj, dict):
        return {k: to_host_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [to_host_tree(v) for v in obj]
        return tuple(t) if isinstance(obj, tuple) else t
    if isinstance(obj, NDArray):
        return tensor_to_host(obj._data)
    if isinstance(obj, torch.Tensor):
        return tensor_to_host(obj)
    return obj


# ---------------------------------------------------------------------------
# pickles with bfloat16 arrays, without ml_dtypes
# ---------------------------------------------------------------------------
# numpy has no bfloat16 of its own: the JAX package pickles its bf16
# arrays as numpy arrays of ``ml_dtypes.bfloat16``, a global that pickle
# resolves by import on both ends, and the card's machine has no
# ml_dtypes.  ``dumps`` writes a ``HostBF16`` in exactly numpy's form for
# such an array, naming the global without importing it; ``loads`` reads
# such an array back as a ``HostBF16`` whether ml_dtypes exists or not.

class _MLBFloat16:
    """Stands for the class ``ml_dtypes.bfloat16`` in a pickle."""


_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)  # numpy's, for it
# numpy's array reconstructor (numpy._core or numpy.core by version)
_RECONSTRUCT = np.zeros(0).__reduce__()[0]


class _BF16Dtype:
    """Stands for ``np.dtype(ml_dtypes.bfloat16)``: pickles as numpy
    pickles that dtype; what ``loads`` makes of one."""

    def __reduce__(self):
        return (np.dtype, (_MLBFloat16, False, True), _BF16_DTYPE_STATE)

    def __setstate__(self, state):
        pass


def _reduce_host_bf16(a: HostBF16):
    return (_RECONSTRUCT, (np.ndarray, (0,), b"b"),
            (1, a.bits.shape, _BF16Dtype(), False, a.bits.tobytes()))


class _Pickler(pickle._Pickler):
    """The pure-Python pickler (its ``save_global`` can be overridden:
    the C one checks that a global imports) writing ``HostBF16`` as an
    ``ml_dtypes.bfloat16`` array."""

    def reducer_override(self, obj):
        if isinstance(obj, HostBF16):
            return _reduce_host_bf16(obj)
        return NotImplemented

    def save_global(self, obj, name=None):
        if obj is not _MLBFloat16:
            return super().save_global(obj, name)
        self.save("ml_dtypes")
        self.save("bfloat16")
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def dumps(obj) -> bytes:
    """``pickle.dumps(obj, protocol=4)``, with every ``HostBF16`` (and
    bfloat16 tensor, through ``to_host_tree``) as the numpy array of
    ``ml_dtypes.bfloat16`` the JAX package unpickles."""
    import io

    buf = io.BytesIO()
    _Pickler(buf, protocol=4).dump(to_host_tree(obj))
    return buf.getvalue()


class _PendingArray:
    """A numpy array being unpickled; ``loads`` replaces it with the
    array, or with a ``HostBF16`` when its dtype is bfloat16."""

    def __init__(self, args):
        self.args = args
        self.value = None

    def __setstate__(self, state):
        version, shape, dtype, fortran, raw = state
        if isinstance(dtype, _BF16Dtype):
            bits = np.frombuffer(raw, dtype=np.uint16)
            bits = bits.reshape(shape, order="F" if fortran else "C")
            self.value = HostBF16(bits.copy())
        else:
            arr = _RECONSTRUCT(*self.args)
            arr.__setstate__(state)
            self.value = arr


def _make_dtype(obj, align=False, copy=False):
    return _BF16Dtype() if obj is _MLBFloat16 else np.dtype(obj, align, copy)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _MLBFloat16
        if (module, name) == ("numpy", "dtype"):
            return _make_dtype
        if name == "_reconstruct" and module in ("numpy.core.multiarray",
                                                 "numpy._core.multiarray"):
            return lambda *args: _PendingArray(args)
        return super().find_class(module, name)


def _resolve(obj):
    if isinstance(obj, _PendingArray):
        return obj.value
    if isinstance(obj, dict):
        return {k: _resolve(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_resolve(v) for v in obj]
        return tuple(t) if isinstance(obj, tuple) else t
    return obj


def loads(blob: bytes):
    """``pickle.loads`` of a pickle of either package, every
    ``ml_dtypes.bfloat16`` array read as a ``HostBF16`` (no
    ``ml_dtypes`` needed), every other array as numpy."""
    import io

    return _resolve(_Unpickler(io.BytesIO(blob)).load())


def _cuda_device(obj):
    """The CUDA device of the first CUDA tensor in ``obj``, or None."""
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for v in obj:
            dev = _cuda_device(v)
            if dev is not None:
                return dev
        return None
    t = obj._data if isinstance(obj, NDArray) else obj
    if isinstance(t, torch.Tensor) and t.is_cuda:
        return t.device
    return None


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Snapshots the whole training state of one process and writes and
    commits it, off the training thread by default.

    - ``directory``: the checkpoint root.
    - ``keep``: the newest committed checkpoints kept (older ones are
      removed after each commit).
    - ``every_n_steps``: the save cadence inside ``fit`` (0: only manual
      and SIGTERM saves).
    - ``async_save``: True writes and commits on a background thread
      (the training thread waits only for the snapshot's device
      copies); False blocks through the commit.

    Each falls back to its ``MXNET_CKPT_*`` variable.  A rank other
    than 0 or more than one shard is not ported yet (queue A item 9).
    """

    def __init__(self, directory: str, keep: Optional[int] = None,
                 every_n_steps: Optional[int] = None,
                 async_save: Optional[bool] = None,
                 rank: Optional[int] = None,
                 num_shards: Optional[int] = None,
                 kvstore=None, logger: Optional[logging.Logger] = None):
        rank = int(rank if rank is not None
                   else os.environ.get("MXNET_WORKER_ID", 0))
        num_shards = int(num_shards if num_shards is not None
                         else os.environ.get("MXNET_NUM_WORKERS", 1))
        if rank != 0 or num_shards != 1 or kvstore is not None:
            raise not_ported("a CheckpointManager over several ranks "
                             "(distribution, queue A item 9)")
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.keep = int(_env("MXNET_CKPT_KEEP", keep, minimum=1))
        self.every_n_steps = int(
            _env("MXNET_CKPT_EVERY_N_STEPS", every_n_steps, minimum=0))
        a = _env("MXNET_CKPT_ASYNC", async_save)
        self.async_save = bool(int(a) if not isinstance(a, bool) else a)
        self.commit_timeout = float(
            _env("MXNET_CKPT_COMMIT_TIMEOUT", None, minimum=0.0))
        self._crash = _CrashInjector(os.environ.get("MXNET_CKPT_CRASH"))
        self.logger = logger or logging.getLogger(
            "mxnet_tpu_torch.checkpoint")
        self.rank, self.num_shards = 0, 1

        self._module = None
        self._train_iter = None
        self._last = {"epoch": 0, "nbatch": -1}
        self._step = 0          # the update count; the checkpoint's id
        self._save_count = 0    # saves made (the crash injection's n)
        self._in_step = False
        self._exiting = False
        self._preempted = False
        self._signum = None
        self._prev_handler = None
        self._iter_warned = False

        self._queue: queue.Queue = queue.Queue(maxsize=4)
        self._writer: Optional[threading.Thread] = None
        self._writer_lock = threading.Lock()
        self._stream = None     # the writer's CUDA stream
        self.last_error: Optional[BaseException] = None
        # the last save's times and size (ms, ms, bytes)
        self.last_blocking_ms = self.last_save_ms = None
        self.last_bytes = None

    # -- fit integration ---------------------------------------------------
    def attach(self, module, train_iter=None) -> None:
        """Keep the module and iterator that cadence and emergency saves
        snapshot."""
        self._module = module
        if train_iter is not None:
            self._train_iter = train_iter

    def step_begin(self) -> None:
        self._in_step = True

    def step_end(self, module, epoch: int, nbatch: int,
                 train_iter=None) -> None:
        """After each update: count it, save on the
        ``every_n_steps`` cadence, and finish a deferred SIGTERM save."""
        self._in_step = False
        self.attach(module, train_iter)
        self._step += 1
        self._last = {"epoch": int(epoch), "nbatch": int(nbatch)}
        if self.every_n_steps and self._step % self.every_n_steps == 0:
            self.save(epoch=epoch, nbatch=nbatch)
        if self._preempted:
            self._emergency_exit()

    # -- save ----------------------------------------------------------------
    def save(self, module=None, epoch: Optional[int] = None,
             nbatch: Optional[int] = None, train_iter=None,
             step: Optional[int] = None, sync: Optional[bool] = None,
             reason: str = "periodic") -> None:
        """Checkpoint now: async, block only for the snapshot; ``sync``,
        through the commit."""
        module = module if module is not None else self._module
        if module is None:
            raise MXNetError("CheckpointManager.save: no module attached "
                             "(pass one or call attach/fit first)")
        train_iter = train_iter if train_iter is not None \
            else self._train_iter
        if sync is None:
            sync = not self.async_save
        t0 = time.perf_counter()
        snap = self._snapshot(
            module,
            self._last["epoch"] if epoch is None else int(epoch),
            self._last["nbatch"] if nbatch is None else int(nbatch),
            train_iter, self._step if step is None else int(step), reason)
        self._save_count += 1
        snap["_save_count"] = self._save_count
        if sync:
            self.flush()  # shard writes stay in order
            self._process(snap)
        else:
            self._ensure_writer()
            try:
                # backpressure: wait for a slot while the writer has a
                # backlog; only a hung writer drops the save
                self._queue.put(snap, timeout=self.commit_timeout)
            except queue.Full:
                self.logger.warning(
                    "[ckpt] writer stuck for %.0fs; skipping save at "
                    "step %d (storage hang?)", self.commit_timeout,
                    snap["step"])
        self.last_blocking_ms = (time.perf_counter() - t0) * 1e3

    def _snapshot(self, module, epoch, nbatch, train_iter, step, reason):
        """The training state as device copies (``get_params`` clones,
        the fused state's clones) and host values, with a CUDA event
        after the copies; nothing here waits for the device."""
        arg_params, aux_params = module.get_params()
        snap: Dict[str, Any] = {
            "format": FORMAT,
            "step": int(step),
            "epoch": int(epoch),
            "nbatch": int(nbatch),
            "rank": self.rank,
            "num_shards": self.num_shards,
            "mesh": None,
            "reason": reason,
            "wall_time": time.time(),
            "arg_params": arg_params,
            "aux_params": aux_params,
            "optimizer": self._snapshot_optimizer(module),
            "rng": None,  # the JAX package's threefry key: not ours
            "torch_rng": {"chain": _random.get_state()},
            "iter_state": self._snapshot_iter(train_iter),
        }
        dev = _cuda_device(snap)
        if dev is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            snap["_event"] = event
        return snap

    def _snapshot_optimizer(self, module):
        if not getattr(module, "optimizer_initialized", False):
            return None  # a parameters-only snapshot
        to_host = getattr(module, "_optimizer_states_to_host", None)
        if to_host is not None:
            return to_host(lazy=True)
        saver = getattr(module, "save_optimizer_states", None)
        if saver is None:
            return None
        with tempfile.TemporaryDirectory() as d:
            tmp = os.path.join(d, "opt.states")
            saver(tmp)
            with open(tmp, "rb") as f:
                return {"kind": "blob", "blob": f.read()}

    def _snapshot_iter(self, train_iter):
        state_dict = getattr(train_iter, "state_dict", None)
        if state_dict is None:
            return None
        try:
            return state_dict()
        except MXNetError as exc:
            if not self._iter_warned:
                self._iter_warned = True
                self.logger.warning(
                    "[ckpt] data iterator position not checkpointed (%s); "
                    "resume will restart the epoch's data", exc)
            return None

    # -- the writer ----------------------------------------------------------
    def _ensure_writer(self):
        with self._writer_lock:
            if self._writer is None or not self._writer.is_alive():
                self._writer = threading.Thread(
                    target=self._writer_loop, name="ckpt-writer", daemon=True)
                self._writer.start()

    def _writer_loop(self):
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            try:
                self._process(job)
            except BaseException as exc:  # keep the writer alive
                self.last_error = exc
                self.logger.exception(
                    "[ckpt] background save at step %s failed",
                    job.get("step"))
            finally:
                self._queue.task_done()

    def flush(self) -> None:
        """Wait until every queued save is written and committed."""
        if self._writer is not None:
            self._queue.join()

    def close(self) -> None:
        """Finish the queued saves and stop the writer thread."""
        with self._writer_lock:
            writer, self._writer = self._writer, None
        if writer is not None and writer.is_alive():
            self._queue.put(None)
            writer.join()

    def _host(self, snap):
        """``snap`` on the host: device copies move on the writer's own
        stream once the snapshot's event has passed, and are held until
        their copies are done."""
        event = snap.pop("_event", None)
        if event is None:
            return to_host_tree(snap)
        dev = _cuda_device(snap)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(event)
            return to_host_tree(snap)

    def _process(self, snap) -> None:
        t0 = time.perf_counter()
        step = snap["step"]
        save_count = snap.pop("_save_count", self._save_count)
        rank = snap["rank"]
        final = os.path.join(self.dir, f"{_DIR_PREFIX}{step:012d}")
        tmp = final + _TMP_SUFFIX
        if os.path.isdir(final):
            snap.pop("_event", None)
            self.logger.info("[ckpt] step %d already committed; skipping",
                             step)
            return
        os.makedirs(tmp, exist_ok=True)

        blob = dumps(self._host(snap))
        sha = hashlib.sha256(blob).hexdigest()
        shard_path = os.path.join(tmp, _shard_name(rank))
        if self._crash.armed("mid_shard", save_count):
            # fault injection: a torn shard under its final name
            with open(shard_path, "wb") as f:
                f.write(blob[:max(1, len(blob) // 2)])
                f.flush()
                os.fsync(f.fileno())
            self._crash.fire()
        atomic_write_bytes(shard_path, blob)
        atomic_write_bytes(
            os.path.join(tmp, f"shard-{rank:05d}.ok"),
            json.dumps({"sha256": sha, "bytes": len(blob),
                        "step": step}).encode())
        if self._crash.armed("before_commit", save_count):
            self._crash.fire()
        if self._commit(step, tmp, final, snap["num_shards"]):
            self._gc()
        self.last_bytes = len(blob)
        self.last_save_ms = (time.perf_counter() - t0) * 1e3

    def _commit(self, step, tmp, final, num_shards) -> bool:
        """Write ``COMMIT`` once every shard's marker exists, then rename
        the directory into place."""
        shards: Dict[str, Any] = {}
        for r in range(num_shards):
            try:
                with open(os.path.join(tmp, f"shard-{r:05d}.ok")) as f:
                    shards[f"{r:05d}"] = json.load(f)
            except (OSError, ValueError):
                self.logger.error("[ckpt] step %d: shard %d never arrived; "
                                  "leaving uncommitted %s", step, r, tmp)
                return False
        manifest = {"format": FORMAT, "step": step,
                    "num_shards": num_shards, "shards": shards,
                    "wall_time": time.time()}
        atomic_write_bytes(os.path.join(tmp, _COMMIT_FILE),
                           json.dumps(manifest, indent=1).encode())
        _fsync_dir(tmp)
        os.rename(tmp, final)
        _fsync_dir(self.dir)
        self.logger.info("[ckpt] committed step %d -> %s", step, final)
        return True

    def _gc(self) -> None:
        """Keep the newest ``keep`` committed checkpoints; remove older
        ones and every torn attempt older than the newest commit."""
        infos = list_checkpoints(self.dir)
        committed = [i for i in infos if i.committed]
        if not committed:
            return
        newest = committed[-1].step
        for info in committed[:-self.keep]:
            shutil.rmtree(info.path, ignore_errors=True)
            self.logger.info("[ckpt] GC: removed %s", info.path)
        for info in infos:
            if not info.committed and info.step < newest:
                shutil.rmtree(info.path, ignore_errors=True)
                self.logger.info("[ckpt] GC: removed torn %s", info.path)

    # -- restore -------------------------------------------------------------
    def load_latest(self) -> Optional[Dict[str, Any]]:
        """The newest committed, checksum-clean snapshot (or None); a
        corrupt newest one is passed over with a warning.  Torn attempts
        are removed."""
        for info in reversed(list_checkpoints(self.dir)):
            if not info.committed:
                continue
            try:
                state = load_shard(info.path, self.rank)
            except MXNetError as exc:
                self.logger.warning(
                    "[ckpt] %s unusable (%s); falling back to the "
                    "previous committed checkpoint", info.path, exc)
                continue
            self._step = int(state["step"])
            self._save_count = 0
            # retire the torn attempts of the run this one supersedes
            for torn in list_checkpoints(self.dir):
                if not torn.committed and torn.path.endswith(_TMP_SUFFIX):
                    shutil.rmtree(torn.path, ignore_errors=True)
            self.logger.info("[ckpt] resuming from %s (step %d, epoch %d, "
                             "batch %d)", info.path, state["step"],
                             state["epoch"], state["nbatch"])
            return state
        return None

    def restore_training_state(self, module, state: Dict[str, Any],
                               train_iter=None) -> None:
        """Install all but the parameters (which go through
        ``init_params``): the optimizer state, the randomness, the
        iterator's position.  Call after ``init_optimizer``."""
        self.attach(module, train_iter)
        payload = state.get("optimizer")
        if payload:
            self._install_optimizer(module, payload)
        foreign = []
        if state.get("rng") is not None:
            foreign.append("rng")
        if payload and payload.get("fused_key") is not None:
            foreign.append("fused_key")
        if foreign:
            self.logger.warning(
                "[ckpt] the checkpoint's %s (the JAX package's threefry "
                "keys) cannot be reproduced by the port and is ignored: "
                "random draws after the resume differ from that run's",
                " and ".join(foreign))
        port_rng = state.get("torch_rng")
        if port_rng:
            _random.set_state(port_rng.get("chain"))
        it_state = state.get("iter_state")
        if it_state is not None and train_iter is not None:
            try:
                train_iter.set_state(it_state)
            except MXNetError as exc:
                self.logger.warning(
                    "[ckpt] could not restore data-iterator position "
                    "(%s); the epoch's data restarts", exc)
        self._step = int(state["step"])

    def _install_optimizer(self, module, payload) -> None:
        install = getattr(module, "_install_optimizer_states", None)
        if install is not None and payload.get("kind") != "blob":
            install(payload)
            return
        loader = getattr(module, "load_optimizer_states", None)
        if loader is None:
            raise MXNetError("module cannot restore optimizer states")
        if payload.get("kind") == "fused":
            blob = dumps({"format": FUSED_STATES_FORMAT,
                          "step": payload["step"],
                          "states": payload["states"]})
        else:
            blob = payload.get("blob", b"")
        if not blob:
            return
        with tempfile.TemporaryDirectory() as d:
            tmp = os.path.join(d, "opt.states")
            with open(tmp, "wb") as f:
                f.write(blob)
            loader(tmp)

    # -- preemption ----------------------------------------------------------
    def install_signal_handler(self, signum: int = signal.SIGTERM) -> bool:
        """On ``signum`` save synchronously at the next step boundary (at
        once between steps), then raise the signal again so the process
        ends as it would have.  False off the main thread, where no
        handler can be installed."""
        try:
            self._prev_handler = signal.signal(signum, self._on_signal)
        except ValueError:
            return False
        self._signum = signum
        return True

    def _on_signal(self, signum, frame):
        self.logger.warning("[ckpt] signal %d: emergency checkpoint "
                            "requested", signum)
        self._preempted = True
        if not self._in_step:
            self._emergency_exit()

    def _emergency_exit(self):
        # a second signal during the save re-enters here: one save, one
        # exit
        if self._exiting:
            return
        self._exiting = True
        signum = self._signum or signal.SIGTERM
        try:
            if self._module is not None and self._step > 0:
                self.save(sync=True, reason="preempt")
            self.close()
        finally:
            try:
                signal.signal(signum, self._prev_handler or signal.SIG_DFL)
            except ValueError:
                pass
            os.kill(os.getpid(), signum)
