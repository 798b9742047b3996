"""Framework randomness: the seeded generators of initializers, the
step-key chain of the executor, and the sampler keying of the serving
engine.

``seed`` is the counterpart of ``mx.random.seed``: it reseeds one
explicit ``torch.Generator`` per device, which the initializers draw
from.  JAX's threefry bits cannot be reproduced, so tests carry
parameters across packages and never seeds.

The step-key chain (``next_key``, ``get_state``, ``set_state``) is the
counterpart of ``mxnet_tpu/random.py:32-62``: one 63-bit chain per
process, started by ``seed``, that advances once a call.  The executor
draws one step key a forward and keys each random node with
``sub_key(step_key, node_index)`` (the JAX executor's ``fold_in(key,
node_index)``), the fused RNN each layer's dropout with ``sub_key(
node_key, layer)``.

The fused training step (``module/fused_step.py``) keys its random
nodes with ``Streams``: a base key drawn once from ``next_key`` when the
step is built (the JAX step's ``base_key``), and one persistent
generator per node, seeded once with ``sub_key(base_key, node_index)``,
whose state runs on from step to step (the JAX step folds ``t`` into
the base key instead).  On the card each generator is registered with
every CUDA graph of the step, so a replay advances its Philox offset
and draws new masks.

Sampler keying: one counter-based draw per (engine seed, stream seed,
absolute position), and for the speculative verify sampler two sub-keys
of that key (``sub_key(key, 1)`` for the acceptance uniform,
``sub_key(key, 2)`` for the residual draw: the JAX sampler's
``fold_in(key, 1)`` / ``fold_in(key, 2)``).

Counterpart of the keying in ``mxnet_tpu/serving.py:sample_tokens``,
where each draw uses ``fold_in(fold_in(base_key, stream_seed),
position)``.  Here the three integers are mixed on the host into one
64-bit seed for an explicit ``torch.Generator`` on the logits' device
(Philox on CUDA, a counter-based generator), so a stream samples the
same tokens whatever batch it rides in.  The bits differ from JAX's
threefry; only the keying contract carries over.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["seed", "generator", "next_key", "get_state", "set_state",
           "key_generator", "Streams", "stream_key", "sub_key",
           "gumbel_noise", "uniform"]

_lock = threading.Lock()
_seed = 0
_generators: Dict[torch.device, torch.Generator] = {}
# the step-key chain; None until the first next_key after a seed
_chain: Optional[int] = None


def seed(seed_state: int) -> None:
    """Seed all framework randomness (``mx.random.seed``): every
    device's generator and the step-key chain restart from
    ``seed_state``."""
    global _seed, _chain
    with _lock:
        _seed = int(seed_state)
        _generators.clear()
        _chain = None


def generator(device) -> torch.Generator:
    """The framework generator of ``device``, seeded by the last
    ``seed`` call (0 before any)."""
    device = torch.device(device)
    with _lock:
        g = _generators.get(device)
        if g is None:
            g = torch.Generator(device=device)
            g.manual_seed(_seed)
            _generators[device] = g
        return g

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_key(engine_seed: int, stream_seed: int, position: int) -> int:
    """A 63-bit generator seed for the draw of ``stream_seed`` at
    ``position`` under ``engine_seed``: distinct triples give unrelated
    seeds, equal triples the same seed."""
    k = _splitmix64(int(engine_seed) & _MASK64)
    k = _splitmix64(k ^ (int(stream_seed) & _MASK64))
    k = _splitmix64(k ^ (int(position) & _MASK64))
    return k >> 1


def sub_key(key: int, i: int) -> int:
    """The ``i``-th sub-key of a ``stream_key``: a further draw keyed by
    the same (engine seed, stream seed, position), unrelated to the
    key's own draw and to the other sub-keys."""
    return _splitmix64(_splitmix64(int(key) & _MASK64)
                       ^ (int(i) & _MASK64)) >> 1


def next_key() -> int:
    """The next 63-bit key of the process's chain (thread-safe): the
    chain steps to ``sub_key(chain, 0)`` and hands out ``sub_key(chain,
    1)``, as ``jax.random.split`` keeps one half and returns the
    other."""
    global _chain
    with _lock:
        if _chain is None:
            _chain = stream_key(_seed, 0, 0)
        key = sub_key(_chain, 1)
        _chain = sub_key(_chain, 0)
        return key


def get_state() -> Optional[int]:
    """The chain's state for a checkpoint (None before its first key
    since the last ``seed``)."""
    with _lock:
        return _chain


def set_state(state: Optional[int]) -> None:
    """Restore a ``get_state`` snapshot: the chain continues where the
    snapshot was taken.  None leaves the chain as it is."""
    global _chain
    if state is None:
        return
    with _lock:
        _chain = int(state)


def key_generator(key: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``key``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(key))
    return g


class Streams:
    """Persistent generators keyed by 63-bit keys under one
    ``base_key``: ``generator(key, device)`` makes a generator seeded
    with ``key`` at its first request and hands the same object out
    after, so its draws run on.  The executor gives node ``i`` the one
    keyed ``sub_key(base_key, i)``.

    ``get_state``/``set_state`` carry the streams through a checkpoint
    (the JAX step needs only its base key and ``t``, since it folds ``t``
    into the key; here each generator's state runs on and must be kept
    too).  A state set for a generator not made yet is held and applied
    when ``generator`` makes it.  On the card ``get_state`` of a
    generator registered with CUDA graphs includes their replays' Philox
    offsets (a replay advances the generator's offset on the host before
    it launches)."""

    def __init__(self, base_key: int):
        self.base_key = int(base_key)
        self._generators: Dict[tuple, torch.Generator] = {}
        self._pending: Dict[tuple, torch.Tensor] = {}

    def generator(self, key: int, device) -> torch.Generator:
        device = torch.device(device)
        g = self._generators.get((key, device))
        if g is None:
            g = self._generators[(key, device)] = key_generator(key, device)
            state = self._pending.pop((key, device.type), None)
            if state is not None:
                g.set_state(state)
        return g

    def generators(self):
        """Every generator made so far."""
        return list(self._generators.values())

    def get_state(self) -> dict:
        """The base key and each generator's state, as builtins and numpy
        (a checkpoint's pickle): ``{"base_key": int, "generators":
        [(key, device type, uint8 state), ...]}``; the states held for
        generators not made yet are included."""
        gens = [(int(k), d.type, g.get_state().numpy().copy())
                for (k, d), g in self._generators.items()]
        gens += [(int(k), t, s.numpy().copy())
                 for (k, t), s in self._pending.items()]
        return {"base_key": self.base_key, "generators": gens}

    def set_state(self, state: dict) -> None:
        """Restore a ``get_state`` snapshot: the base key, then each
        generator's state, set on a generator made already (of the same
        key and device type) or held until it is made.  A CUDA graph that
        registered a generator must be dropped before (the module's
        ``FusedState.install`` does)."""
        self.base_key = int(state["base_key"])
        self._pending = {}
        made = {(k, d.type): g for (k, d), g in self._generators.items()}
        for key, dev_type, arr in state["generators"]:
            t = torch.from_numpy(np.array(arr, dtype=np.uint8, copy=True))
            g = made.get((int(key), dev_type))
            if g is not None:
                g.set_state(t)
            else:
                self._pending[(int(key), dev_type)] = t
        # generators of other keys belong to another base key
        keys = {(int(k), t) for k, t, _ in state["generators"]}
        self._generators = {(k, d): g for (k, d), g in
                            self._generators.items() if (k, d.type) in keys}


def _draw(key: int, n: int, device) -> torch.Tensor:
    return torch.rand(n, generator=key_generator(key, device), device=device,
                      dtype=torch.float32)


def gumbel_noise(keys: Sequence[int], n: int,
                 device: torch.device) -> torch.Tensor:
    """(len(keys), n) float32 standard Gumbel noise, row ``i`` drawn
    from a generator seeded with ``keys[i]`` on ``device``.  Each row is
    transformed on its own, so its bits do not depend on the other
    rows (the CPU's vector math would otherwise round a row's tail by
    its offset in the batch)."""
    # u in [0, 1): u == 0 maps to -inf (never the argmax), u < 1 always
    return torch.stack([-torch.log(-torch.log(_draw(k, n, device)))
                        for k in keys])


def uniform(keys: Sequence[int], device: torch.device) -> torch.Tensor:
    """(len(keys),) float32 uniforms in [0, 1), one per key."""
    return torch.cat([_draw(k, 1, device) for k in keys])
