"""The catalog of the environment variables the port reads.

Counterpart of ``mxnet_tpu/config.py``'s ``register_env``, ``list_env``,
``describe`` and ``current``: every ``MXNET_*`` variable that
``mxnet_tpu_torch`` reads is declared here, with its type, its default
(the JAX package's, but for ``MXNET_SERVING_PREFIX_CACHE``: the prefix
cache is not ported, so the port's default is off) and what it does,
and only those.  ``tests/test_torch_config.py`` holds the package to
it.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Any, Dict, List

from .base import get_env

__all__ = ["EnvVar", "register_env", "list_env", "describe", "current"]

EnvVar = namedtuple("EnvVar", ["name", "default", "dtype", "doc"])

_CATALOG: Dict[str, EnvVar] = {}


def register_env(name: str, default, dtype: type, doc: str) -> None:
    """Declare an environment variable the port reads."""
    _CATALOG[name] = EnvVar(name, default, dtype, doc)


def list_env() -> List[EnvVar]:
    """Every declared variable, sorted by name."""
    return [_CATALOG[k] for k in sorted(_CATALOG)]


def describe(name: str) -> EnvVar:
    if name not in _CATALOG:
        raise KeyError(f"{name!r} is not a declared mxnet_tpu_torch env "
                       f"var; known: {sorted(_CATALOG)}")
    return _CATALOG[name]


def current() -> Dict[str, Any]:
    """The value of every declared variable: the environment's, or the
    default."""
    return {v.name: get_env(v.name, v.default, v.dtype) for v in list_env()}


# -- training ---------------------------------------------------------------
register_env(
    "MXNET_FUSED_STEP", "1", str,
    "'1' (default): Module training runs the fused step (forward, "
    "backward and the optimizer as one function, a CUDA graph on the "
    "card); '0': the executor's forward and backward, then the Updater "
    "on each parameter.  Read at Module construction.")
register_env(
    "MXNET_BACKWARD_DO_MIRROR", 0, int,
    "1: the training forward runs under torch.utils.checkpoint and is "
    "recomputed in backward, its activations not kept (random draws "
    "are kept from the forward).  Read at executor bind.")
register_env(
    "MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice", str,
    "'NaiveEngine': every executor run and training step finishes on "
    "the card before it returns, so a fault shows at its call; the two "
    "threaded names: the normal asynchronous queueing.  Read at "
    "import.")
# -- checkpoints --------------------------------------------------------------
register_env(
    "MXNET_CKPT_DIR", None, str,
    "Checkpoint root directory: Module.fit makes a CheckpointManager "
    "there when set.")
register_env(
    "MXNET_CKPT_EVERY_N_STEPS", 0, int,
    "Checkpoint every N optimizer steps inside Module.fit (0 = only "
    "manual and SIGTERM saves).")
register_env("MXNET_CKPT_KEEP", 5, int, "Newest committed checkpoints kept.")
register_env(
    "MXNET_CKPT_ASYNC", 1, int,
    "1: write and commit on a background thread; 0: block through the "
    "commit.")
register_env(
    "MXNET_CKPT_COMMIT_TIMEOUT", 300.0, float,
    "Seconds the commit waits for the shard markers.")
register_env(
    "MXNET_CKPT_CRASH", None, str,
    "Fault injection for tests: 'mid_shard[:n]' or 'before_commit[:n]'.")
register_env(
    "MXNET_NUM_WORKERS", 1, int,
    "Process count of a run: a CheckpointManager's shard count.")
register_env(
    "MXNET_WORKER_ID", 0, int,
    "This process's rank: the CheckpointManager shard it writes.")
# -- serving ------------------------------------------------------------------
register_env(
    "MXNET_SERVING_KV_BLOCK", 16, int,
    "DecodeEngine cache page size in tokens.")
register_env(
    "MXNET_SERVING_MAX_STREAMS", 64, int,
    "DecodeEngine concurrent-stream ceiling.")
register_env(
    "MXNET_SERVING_DECODE_BUCKETS", None, str,
    "DecodeEngine decode batch ladder (comma-separated, increasing).")
register_env(
    "MXNET_SERVING_CACHE_BUCKETS", None, str,
    "DecodeEngine cache-length ladder (comma-separated, increasing).")
register_env(
    "MXNET_SERVING_PREFILL_BUCKETS", None, str,
    "DecodeEngine prefill-length ladder (comma-separated, increasing).")
register_env(
    "MXNET_SERVING_KV_DTYPE", "fp32", str,
    "DecodeEngine page storage: 'fp32' (the weights' dtype), 'int8' or "
    "'fp8' (quantized pages with per-row scales).")
register_env(
    "MXNET_SERVING_SPEC_TOKENS", 0, int,
    "Speculative draft depth k (0 = plain decoding).")
register_env(
    "MXNET_SERVING_PROPOSER", "ngram", str,
    "Draft proposer of speculative decoding ('ngram').")
register_env(
    "MXNET_SERVING_PREFIX_CACHE", 0, int,
    "1 asks for the prefix cache, which is not ported and raises; 0 "
    "(the port's default) serves without it.")
register_env(
    "MXNET_SERVING_EVICT", "lru", str,
    "Prefix-cache eviction policy; not ported: setting it raises.")
register_env(
    "MXNET_SERVING_PREFILL_CHUNK", 0, int,
    "Chunked prefill; not ported: a value other than 0 raises.")
register_env(
    "MXNET_SERVING_TP", 1, int,
    "Tensor-parallel serving degree; not ported: other than 1 raises.")
register_env(
    "MXNET_SERVING_PP", 1, int,
    "Pipeline-parallel serving degree; not ported: other than 1 raises.")
register_env(
    "MXNET_SERVING_DEVICES", None, str,
    "Devices of a model-parallel engine; not ported: setting it raises.")
register_env(
    "MXNET_ADAPTER_ENABLE", 0, int,
    "LoRA adapters in serving; not ported: 1 raises.")
register_env(
    "MXNET_TENANT_QUOTA_TOKENS", 0, int,
    "Per-tenant token quotas in serving; not ported: other than 0 "
    "raises.")
