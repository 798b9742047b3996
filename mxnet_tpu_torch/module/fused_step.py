"""The Module's fused training step, and its CUDA graphs on the card.

Counterpart of the JAX ``Module``'s one donated XLA program
(``mxnet_tpu/module/module.py``: ``_build_fused_step`` ``:916-971``,
``_make_param_update`` ``:1296-1363``, ``_run_fused_step``
``:1842-1918``, ``_lr_device`` ``:1765-1783``).  ``TrainStep`` is one
function of a bound executor's arrays: the forward over every argument
that needs a gradient, the backward from all-ones heads into
``grad_dict``, then the optimizer segment, ``Optimizer.apply`` once per
(lr_mult, wd_mult) group over every parameter of the group
(``FusedState.apply``). Parameters bound to one storage get their own
copies before the first step (``untie``). The base learning rate and the
update number ``t`` are 0-dim float64 tensors on the device: the host
writes the rate with ``fill_`` only when the scheduler's value changes,
and the step itself advances ``t``, so replaying a captured step reads
both from the device and the host copies no scalar a step. Random nodes
draw from the ``random.Streams`` of the state (a generator a node,
seeded once from a base key drawn when the state is made), which the
steps of every bucket share.

``Graphed`` runs such a function on the card as a CUDA graph: its first
``_WARMUP_STEPS`` calls run eagerly on a side stream (real steps, which
also build and load every kernel at its first use), the next call is
captured on that same stream into the module's graph pool, with no
garbage collection meanwhile, and replayed once to perform it, and every
later call replays (captured in the ``thread_local`` error mode, so that
another thread's CUDA work, such as a checkpoint writer's copies, may go
on meanwhile).  A capture on a stream of its own (``torch.cuda.graph``'s
way) met cuBLAS's and cuDNN's per-stream state first inside the
capture.  The executor keeps cuDNN to its deterministic algorithms
(``executor._cudnn_algorithms``), in the warm-ups and the capture as
in the eager steps, so graphed and eager steps are equal bit for bit.
The batch
is copied into the bound argument arrays outside the graph; they are
its static inputs.  A replay's outputs are handed out as copies, so outputs a
caller keeps are not overwritten by the next step.  Before each replay
every array the graph captured (arguments, gradients, aux states,
optimizer states, ``t`` and the rate) must still be the same tensor:
``set_params`` writes in place, but a replaced ``_data`` drops the
graph, and the next calls warm up and capture again.  The kernels'
launch counters (``cuda_kernels.LAUNCHES``, ``rtc.LAUNCHES``) count
Python calls: the counts a capture made are taken back and kept as the
graph's ``launches`` (the kernels it holds), and added again at every
replay.  That is bookkeeping, not an observation of a replay: a
profiler trace of the replays (``chip_smoke.py``'s ``TracedLaunches``)
sees the kernels themselves.  The generators of the streams are
registered with every graph, so each replay advances their Philox
offsets and draws new masks.

A checkpoint carries the state to the host and back:
``FusedState.to_host`` gives the per-name state trees (device copies,
or numpy), the step count and the streams' snapshot;
``FusedState.install`` writes a checkpoint's trees with ``copy_`` into
the tensors that exist (a captured graph keeps reading them), sets
``t`` and the step count, and restores the streams, which drops every
graph of the state (its ``version`` changes): a graph registered the
generators whose states were set, so the steps warm up and capture
again.

Whether a symbol is captured is decided from the registry before any
capture: an op registered ``capturable=False`` (``Custom``, whose
Python body runs per call) makes the module run the same function
uncaptured.  A capture that fails raises.  On the CPU the function runs
uncaptured too: CUDA graphs exist only on the card.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from .. import random as _random
from ..base import MXNetError
from ..checkpoint import to_host_tree
from ..ndarray import tensor_from_numpy
from ..optimizer import place_state
from ..ops.registry import get_op

__all__ = ["uncapturable_ops", "untie", "FusedState", "TrainStep",
           "InferStep", "Graphed"]

# eager calls of a new graph before its capture
_WARMUP_STEPS = 2


def uncapturable_ops(symbol) -> List[str]:
    """The names of the ops of ``symbol`` registered
    ``capturable=False``."""
    return sorted({n.op for n in symbol._topo()
                   if not n.is_variable and not get_op(n.op).capturable})


def _launch_counters():
    from .. import rtc
    from ..ops import cuda_kernels

    return (cuda_kernels.LAUNCHES, rtc.LAUNCHES)


def untie(ex, names):
    """Give each parameter of ``names`` whose storage another bound
    argument or aux state shares (a parameter met earlier, a fixed one,
    an input) a copy of its own, as the JAX step's
    ``_copy_donated_aliases`` does: the names then train as independent
    parameters, and no in-place update lands twice in one storage."""
    def key(t):
        return t.untyped_storage().data_ptr()

    mine = set(names)
    taken = {key(a._data) for n, a in ex.arg_dict.items() if n not in mine}
    taken |= {key(a._data) for a in ex.aux_dict.values()}
    for n in names:
        arr = ex.arg_dict[n]
        if key(arr._data) in taken:
            arr._data = arr._data.clone()
        taken.add(key(arr._data))


class FusedState:
    """The optimizer segment's state: a state per parameter name, the
    update number ``t`` and the base learning rate as 0-dim float64
    tensors on ``device``, the random streams, and the count of steps.
    The modules of a ``BucketingModule`` share one."""

    def __init__(self, optimizer, device, base_key=None):
        self.optimizer = optimizer
        self.states: Dict[str, object] = {}
        self.t = torch.full((), float(optimizer.num_update),
                            dtype=torch.float64, device=device)
        self.lr = torch.zeros((), dtype=torch.float64, device=device)
        self.lr_value = None
        self.streams = _random.Streams(_random.next_key() if base_key is None
                                       else base_key)
        # an optimizer that draws (SGLD) draws from the step's streams
        optimizer.rng_streams = self.streams
        self.step_count = 0
        self.device = torch.device(device)
        # bumped when the streams are restored: graphs of an older
        # version are captured again
        self.version = 0

    def to_host(self, lazy=False):
        """{"step", "states": {name: tree}, "streams"}: each state tree
        (None, a tensor or a tuple of tensors) as device copies with
        ``lazy`` (the checkpoint writer moves them to the host later),
        else as numpy; the streams' snapshot is host data."""
        if lazy:
            with torch.no_grad():
                states = {n: _clone_tree(tree)
                          for n, tree in self.states.items()}
        else:
            states = to_host_tree(self.states)
        return {"step": int(self.step_count), "states": states,
                "streams": self.streams.get_state()}

    def install(self, step, states, streams=None):
        """A checkpoint's state: each tree of ``states`` (numpy or
        tensors, by name) written in place into the state of that name,
        or placed on the device for a name without one yet; ``t`` and
        the step count set to ``step``; the streams restored when given.
        The base rate is written again at the next ``count_update``."""
        with torch.no_grad():
            for n, tree in states.items():
                old = self.states.get(n)
                if old is None or tree is None:
                    self.states[n] = place_state(tree, self.device)
                else:
                    _copy_tree(old, tree)
            self.t.fill_(float(step))
        self.step_count = int(step)
        self.lr_value = None
        if streams is not None:
            self.streams.set_state(streams)
            self.version += 1

    def ensure_states(self, names, weights):
        """Make the states of the ``names`` that have none yet."""
        missing = [(n, w) for n, w in zip(names, weights)
                   if n not in self.states]
        if missing:
            with torch.no_grad():
                made = self.optimizer.init_state_arrays(
                    [w for _, w in missing])
            self.states.update(zip([n for n, _ in missing], made))

    def count_update(self):
        """The host's half of a step: one update count (the JAX step's
        ``_update_count(0)``), then the base rate of ``num_update``,
        written to the device when it changed."""
        opt = self.optimizer
        opt._update_count(0)
        lr = float(opt.lr_scheduler(opt.num_update) if opt.lr_scheduler
                   else opt.lr)
        if lr != self.lr_value:
            self.lr.fill_(lr)
            self.lr_value = lr
        self.step_count += 1

    def apply(self, groups, arg_dict, grad_dict):
        """The device's half: advance ``t``, then one ``apply`` a group
        of (lr_mult, wd, names) over the gradients in ``grad_dict``."""
        self.t.add_(1)
        for lr_mult, wd, names in groups:
            lr = self.lr if lr_mult == 1.0 else self.lr * lr_mult
            self.optimizer.apply([arg_dict[n]._data for n in names],
                                 [grad_dict[n]._data for n in names],
                                 [self.states[n] for n in names], lr, wd,
                                 self.t)

    def tensors(self):
        """Every tensor of the state."""
        out = [self.t, self.lr]
        for s in self.states.values():
            if isinstance(s, torch.Tensor):
                out.append(s)
            elif isinstance(s, (tuple, list)):
                out += [x for x in s if isinstance(x, torch.Tensor)]
        return out


def _clone_tree(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone_tree(x) for x in tree)
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _copy_tree(dst, src):
    if dst is None or src is None:  # DCASGD's (None, w) without momentum
        if dst is not None or src is not None:
            raise MXNetError("an optimizer state of another form than "
                             "this optimizer's")
        return
    if isinstance(dst, (tuple, list)):
        if not isinstance(src, (tuple, list)) or len(src) != len(dst):
            raise MXNetError("an optimizer state of another form than "
                             "this optimizer's")
        for d, x in zip(dst, src):
            _copy_tree(d, x)
        return
    x = src if isinstance(src, torch.Tensor) else tensor_from_numpy(src)
    if tuple(x.shape) != tuple(dst.shape):
        raise MXNetError(f"an optimizer state of shape {tuple(x.shape)} "
                         f"for one of {tuple(dst.shape)}")
    dst.copy_(x)


class TrainStep:
    """Forward, backward and the optimizer segment of the executor
    ``ex`` over ``fused``, for the parameters ``names``, as one function
    of the bound arrays → the outputs."""

    def __init__(self, ex, fused: FusedState, names):
        self.ex = ex
        self.fused = fused
        opt = fused.optimizer
        groups: Dict[tuple, List[str]] = {}
        for n in names:
            key = (float(opt.lr_mult.get(n, 1.0)),
                   float(opt.wd * opt.wd_mult.get(n, 1.0)))
            groups.setdefault(key, []).append(n)
        self.groups = [(lm, wd, ns) for (lm, wd), ns in groups.items()]
        untie(ex, names)
        fused.ensure_states(names, [ex.arg_dict[n]._data for n in names])

    @property
    def streams(self):
        return self.fused.streams

    def __call__(self):
        ex = self.ex
        outs, leaves = ex._run(True, self.fused.streams)
        if leaves is not None:
            ex._backprop(outs, leaves, [torch.ones_like(o) for o in outs])
        self.apply_grads()
        return [o.detach() for o in outs]

    def apply_grads(self):
        """The optimizer segment alone, over ``grad_dict`` as it is."""
        with torch.no_grad():
            self.fused.apply(self.groups, self.ex.arg_dict, self.ex.grad_dict)

    def arrays(self):
        ex = self.ex
        return ([a._data for a in ex.arg_dict.values()]
                + [a._data for a in ex.grad_dict.values()]
                + [a._data for a in ex.aux_dict.values()]
                + self.fused.tensors())


class InferStep:
    """``forward(is_train=False)`` of the executor ``ex`` as a function
    of the bound arrays → the outputs (random nodes draw nothing in
    inference; ``streams`` keys them all the same)."""

    def __init__(self, ex):
        self.ex = ex
        self.streams = _random.Streams(0)

    def __call__(self):
        outs, _ = self.ex._run(False, self.streams)
        return [o.detach() for o in outs]

    def arrays(self):
        return ([a._data for a in self.ex.arg_dict.values()]
                + [a._data for a in self.ex.aux_dict.values()])


def _release_cached_memory():
    """Give the allocators' cached blocks back to the device and the
    pinned host memory back to the host, as ``torch.cuda.graph`` does
    before it captures: a capture allocates only from its own pool and
    cannot take a cached block (SSD300's detection capture ran out of
    memory on the card with 35.44 GiB cached), and this also retires the
    pools of dropped graphs (capturing into a pool whose every graph is
    gone before the allocators retire it fails an assertion of
    theirs)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    host = getattr(torch._C, "_host_emptyCache", None)
    if host is not None:
        host()


class Graphed:
    """``step`` (a ``TrainStep`` or ``InferStep``) under a CUDA graph in
    the memory pool ``pool()`` returns at the capture, every generator
    of ``step.streams`` registered with it."""

    def __init__(self, step, pool):
        self.step = step
        self.pool = pool
        self.graph = None
        self.outs = None
        self.captured = None
        self.launches = None
        self.warm = 0
        self.side = None
        self.captures = 0
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self.version = None

    def _state_version(self):
        fused = getattr(self.step, "fused", None)
        return None if fused is None else fused.version

    def __call__(self):
        arrays = self.step.arrays()
        if self.graph is not None and not (
                len(arrays) == len(self.captured)
                and all(a is b for a, b in zip(arrays, self.captured))
                and self.version == self._state_version()):
            # a captured array was replaced, or the streams restored:
            # warm up and capture again
            self.graph = self.outs = self.captured = None
            self.warm = 0
        if self.graph is None:
            if self.warm < _WARMUP_STEPS:
                self.warm += 1
                return self._eager()
            self._capture(arrays)
        self.graph.replay()
        for counts, delta in zip(_launch_counters(), self.launches):
            for k, n in delta.items():
                counts[k] = counts.get(k, 0) + n
        return [o.clone() for o in self.outs]

    def _eager(self):
        if self.side is None:
            self.side = torch.cuda.Stream()
        main = torch.cuda.current_stream()
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            outs = self.step()
        main.wait_stream(self.side)
        return outs

    def _capture(self, arrays):
        counters = _launch_counters()
        before = [dict(c) for c in counters]
        t0 = time.perf_counter()
        # no garbage collection inside the capture: a CUDA graph freed
        # there (one in a reference cycle) resets itself, which the
        # capture does not permit, and the capture fails
        gc.collect()
        _release_cached_memory()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        for g in self.step.streams.generators():
            if g.device.type == "cuda":
                graph.register_generator_state(g)
        # captured on the warm-ups' stream (torch.cuda.graph would capture
        # on a stream of its own): cuBLAS's and cuDNN's per-stream state
        # and workspaces are the ones the eager steps used, not met
        # first inside the capture.  thread_local: another thread's CUDA
        # calls (a checkpoint writer's copies on its own stream) neither
        # fail this capture nor fail themselves, as they do under the
        # default global mode
        main = torch.cuda.current_stream()
        self.side.wait_stream(main)
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self.side):
                graph.capture_begin(self.pool(),
                                    capture_error_mode="thread_local")
                try:
                    outs = self.step()
                finally:
                    graph.capture_end()
        finally:
            if gc_was_on:
                gc.enable()
        main.wait_stream(self.side)
        self.capture_ms += (time.perf_counter() - t0) * 1e3
        self.pool_bytes += torch.cuda.memory_reserved() - reserved
        self.captures += 1
        # the capture ran no kernel: take back what its calls counted
        self.launches = []
        for counts, old in zip(counters, before):
            delta = {k: n - old.get(k, 0) for k, n in counts.items()
                     if n != old.get(k, 0)}
            for k, n in delta.items():
                counts[k] -= n
            self.launches.append(delta)
        self.graph, self.outs, self.captured = graph, outs, arrays
        self.version = self._state_version()
