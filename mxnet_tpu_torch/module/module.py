"""Module — a Symbol bound on one device, with parameters and an
optimizer.

Counterpart of ``mxnet_tpu/module/module.py``, single-device: ``bind``
(with ``shared_module=``, the parameter sharing of bucketed modules),
``init_params`` (with ``arg_params=``), ``set_params``/``get_params``,
``init_optimizer`` (default ``rescale_grad = 1/batch_size``,
``:542-610``), ``borrow_optimizer``, ``forward``, ``backward``,
``update``, ``get_outputs``, ``update_metric``.

The context defaults to ``gpu(0)`` and is resolved at construction, so
a host without CUDA raises there unless the caller passes ``cpu()``.

Training runs the fused step (``fused_step.py``) by default, as the JAX
``Module`` runs its one XLA program (``MXNET_FUSED_STEP``, read at
construction; ``"0"`` turns it off, ``:160``): once ``_fused_ready``
holds (``:904-914``: an optimizer with ``apply``, no input gradients,
every output a loss head; here also no ``grad_req="add"``, whose
accumulation the JAX step drops), ``forward(is_train=True)`` only keeps
the batch, ``backward()`` does nothing, and ``update()`` runs forward,
backward and the optimizer segment over every parameter as one
function, a CUDA graph on the card.  ``get_outputs()`` (or
``backward(out_grads)``) before ``update()`` runs the batch through the
executor's forward and backward instead, and ``update()`` then applies
its gradients through the same optimizer state (``:1785-1823``,
``:2045-2063``).  On the card ``forward(is_train=False)`` replays a
CUDA graph too (``score``, ``predict``).  ``MXNET_FUSED_STEP=0`` gives
the eager path: the executor's autograd pass, then the ``Updater`` on
each parameter.

Checkpoints follow ``:203-224`` and ``:2102-2390``: ``Module.load``,
``save_checkpoint``, and the optimizer states in both of the JAX
package's files, the fused one (a pickle of {"format", "step",
"states": {name: tree}}) and the ``Updater`` blob, mapped to names for
the fused step; bf16 states pickle as ``ml_dtypes`` arrays through
``checkpoint.dumps``/``loads``, with no ``ml_dtypes`` here.  A restore
before the first fused step is pending and installed when the step
makes its ``FusedState``; the ``Updater`` is filled too, for a module
that ends up on the eager path.
``_optimizer_states_to_host``/``_install_optimizer_states`` carry the
same payload for ``checkpoint.CheckpointManager``.  Multi-device
contexts, kvstores other than ``None``/``'local'``, mesh plans and
monitors are not ported yet and raise.
"""

from __future__ import annotations

import logging
import os

import torch

from .. import optimizer as opt
from .. import random as _random
from ..base import MXNetError, not_ported
from ..checkpoint import (FUSED_STATES_FORMAT, atomic_save,
                          atomic_write_bytes, dumps, loads, to_host_tree)
from ..context import Context, current_context
from ..initializer import InitDesc, Uniform
from ..ndarray import NDArray, dtype_name
from . import fused_step as _fs
from .base_module import BaseModule

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise not_ported("Module over several contexts")
            context = context[0]
        if not isinstance(context, Context):
            raise MXNetError(f"Module context must be a Context, got "
                             f"{context!r}")
        context.torch_device()  # a gpu context without CUDA raises here
        self._context = [context]
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        input_names = self._data_names + self._label_names
        self._param_names = [x for x in symbol.list_arguments()
                             if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._optimizer = None
        self._updater = None
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        # the fused step: its switch, the ops that keep it uncaptured,
        # the optimizer state (shared by the modules of a
        # BucketingModule), the step functions, each a CUDA graph on the
        # card, and the module that holds their graph pool (this one, or
        # the shared module bound to)
        self._use_fused = os.environ.get("MXNET_FUSED_STEP", "1") != "0"
        self._uncapturable = _fs.uncapturable_ops(symbol)
        self._fused = None
        self._train_fn = self._train_step = None
        self._infer_step = None
        self._graph_pool = None
        self._pool_owner = self
        self._pending_batch = None
        self._flushed_backward = False
        # a checkpoint's parameters (Module.load), its optimizer-states
        # file to read at init_optimizer, and its states for the fused
        # step not made yet: (step, states by name, streams or None)
        self._arg_params = self._aux_params = None
        self._preload_opt_states = None
        self._pending_fused_states = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over ``prefix-symbol.json`` whose parameters are
        ``prefix-%04d.params`` (written into its arrays at ``bind``),
        and with ``load_optimizer_states`` the optimizer states of
        ``prefix-%04d.states`` (read at ``init_optimizer``)."""
        from ..model import load_checkpoint

        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    # -- properties ------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._inferred_output_shapes

    # -- parameters --------------------------------------------------------------
    def get_params(self):
        """(arg_params, aux_params): copies of the parameter arrays."""
        self._check_bound()
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return arg, aux

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Fill every parameter from ``arg_params`` where given, else
        from the variable's own ``init`` attr, else ``initializer``."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before initializing the parameters")
        attrs = self._symbol.attr_dict()
        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            if arg_params is not None and name in arg_params:
                arr[:] = arg_params[name]
            elif self._arg_params is not None and name in self._arg_params:
                arr[:] = self._arg_params[name]
            elif allow_missing and initializer is None:
                raise MXNetError(f"cannot init parameter {name}")
            elif initializer is None:
                raise MXNetError(f"parameter {name} missing and no "
                                 f"initializer given")
            else:
                initializer(InitDesc(name, attrs.get(name, {})), arr)
        for name in self._aux_names:
            arr = self._exec.aux_dict[name]
            if aux_params is not None and name in aux_params:
                arr[:] = aux_params[name]
            elif self._aux_params is not None and name in self._aux_params:
                arr[:] = self._aux_params[name]
            elif initializer is not None:
                initializer(InitDesc(name, attrs.get(name, {})), arr)
        self.params_initialized = True

    def _check_bound(self):
        if not (self.binded and self.params_initialized):
            raise MXNetError("the module needs bind() and init_params()")

    # -- binding -----------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Allocate every array on the module's device from the shapes
        (DataDesc or (name, shape) entries) and the DataDescs' dtypes (a
        bf16 or fp16 ``data`` types every homogeneous parameter through
        ``infer_type``; ``BucketingModule`` binds each bucket here).
        With ``shared_module`` the parameters and their gradients are
        that module's NDArray objects (the same storage), which every
        parameter must match."""
        if force_rebind:
            self._exec = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self._train_fn = self._train_step = self._infer_step = None
        self._pending_batch = None
        if inputs_need_grad and not for_training:
            raise MXNetError("inputs_need_grad needs for_training")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [(d[0], tuple(d[1])) for d in data_shapes]
        self._label_shapes = ([(d[0], tuple(d[1])) for d in label_shapes]
                              if label_shapes else None)
        shape_kwargs = dict(self._data_shapes)
        shape_kwargs.update(dict(self._label_shapes or []))
        # the descriptors' dtypes bind the network in them (a bf16 or fp16
        # batch types every homogeneous parameter through infer_type), as
        # mxnet_tpu/module/module.py:336-345
        type_dict = {d[0]: dtype_name(d.dtype)
                     for descs in (data_shapes, label_shapes or [])
                     for d in descs if getattr(d, "dtype", None) is not None}
        req = {}
        for name in self._symbol.list_arguments():
            if name in self._data_names:
                req[name] = "write" if inputs_need_grad else "null"
            elif name in self._label_names \
                    or name in self._fixed_param_names or not for_training:
                req[name] = "null"
            else:
                req[name] = grad_req
        shared_exec = shared_module._exec if shared_module is not None \
            else None
        if shared_module is not None:
            self._pool_owner = shared_module._pool_owner
        self._exec = self._symbol.simple_bind(self._context[0],
                                              grad_req=req,
                                              type_dict=type_dict or None,
                                              shared_exec=shared_exec,
                                              **shape_kwargs)
        _, out_shapes, _ = self._symbol.infer_shape(**shape_kwargs)
        self._inferred_output_shapes = list(zip(self._output_names,
                                                out_shapes))
        self.binded = True
        if self.params_initialized and self._arg_params is not None:
            # Module.load: the checkpoint's parameters into the arrays
            for src, dst in ((self._arg_params, self._exec.arg_dict),
                             (self._aux_params or {}, self._exec.aux_dict)):
                for n, v in src.items():
                    if n in dst:
                        dst[n][:] = v
        if shared_module is not None and shared_module.params_initialized:
            # a parameter the donor lacks, or holds in another shape,
            # would train apart from the shared storage: refuse it
            for n in self._param_names:
                arr = self._exec.arg_dict[n]
                donor = shared_exec.arg_dict.get(n)
                if donor is None:
                    raise MXNetError(
                        f"shared_module is missing parameter {n!r}; "
                        "parameters must be identical across shared modules")
                if arr is not donor:
                    raise MXNetError(
                        f"parameter {n!r} ({arr.shape}/{arr.dtype}) does not "
                        f"match the shared module's ({donor.shape}/"
                        f"{donor.dtype}); bucket-specific parameter shapes "
                        "are not supported")
            self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create the optimizer and its updater; a named optimizer gets
        ``rescale_grad = 1/batch_size`` unless given."""
        self._check_bound()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, "
                                "ignoring...")
            return
        if kvstore not in (None, "local"):
            raise not_ported(f"kvstore {kvstore!r}")
        if isinstance(optimizer, str):
            params = dict(optimizer_params)
            params.setdefault("rescale_grad",
                              1.0 / self._data_shapes[0][1][0])
            optimizer = opt.create(
                optimizer, sym=self._symbol,
                param_idx2name=dict(enumerate(self._param_names)), **params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise MXNetError(f"optimizer must be a name or an Optimizer, "
                             f"got {optimizer!r}")
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self._fused = None
        self._pending_fused_states = None
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Use ``shared_module``'s optimizer and updater (one per
        BucketingModule): the updater keys its state by parameter index,
        so both modules must list the same parameters in the same
        order."""
        if not shared_module.optimizer_initialized:
            raise MXNetError("borrow_optimizer: the shared module has no "
                             "optimizer yet")
        if self._param_names != shared_module._param_names:
            raise MXNetError(
                f"borrow_optimizer: parameters {self._param_names} differ "
                f"from the shared module's {shared_module._param_names}")
        self._optimizer = shared_module._optimizer
        self._updater = shared_module._updater
        self._fused = None
        self.optimizer_initialized = True

    def _adopt_fused_state(self, other):
        """Take over ``other``'s fused state (optimizer states, ``t``,
        the rate and the random streams): a BucketingModule's buckets
        train one state (``mxnet_tpu/module/module.py:771-805``)."""
        if other is not self:
            self._fused = other._fused
            if other._pending_fused_states is not None:
                # a restore not installed yet travels with the state
                self._pending_fused_states = other._pending_fused_states
                other._pending_fused_states = None

    # -- computation -------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """Stage the batch onto the module's device and run the graph;
        under the fused step a training batch waits for ``update()``."""
        self._check_bound()
        if is_train is None:
            is_train = self.for_training
        kwargs = dict(zip(self._data_names, data_batch.data))
        if self._label_names and data_batch.label:
            kwargs.update(zip(self._label_names, data_batch.label))
        self._pending_batch = None
        self._flushed_backward = False
        if is_train and self._fused_ready():
            self._pending_batch = kwargs  # the fused step runs in update()
            return
        if not is_train and self._graphs_on():
            ex = self._exec
            ex._write_inputs(kwargs)
            _random.next_key()  # the eager forward's draw: the same chain
            if self._infer_step is None:
                self._infer_step = _fs.Graphed(_fs.InferStep(ex),
                                               self._pool_handle)
            self._set_outputs(self._infer_step())
            return
        self._exec.forward(is_train=is_train, **kwargs)

    def backward(self, out_grads=None):
        self._check_bound()
        if self._pending_batch is not None:
            if out_grads is None:
                return  # the fused step in update() runs it
            # explicit head gradients: the executor's forward first
            kwargs, self._pending_batch = self._pending_batch, None
            self._exec.forward(is_train=True, **kwargs)
        elif self._flushed_backward and out_grads is None:
            # get_outputs() already ran this batch's backward
            self._flushed_backward = False
            return
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step on every parameter that has a gradient:
        the fused step for a kept batch, the fused state's optimizer
        segment over ``grad_dict`` for a batch the executor ran, or the
        ``Updater`` on each parameter (``MXNET_FUSED_STEP=0``)."""
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer before update")
        if self._pending_batch is not None:
            kwargs, self._pending_batch = self._pending_batch, None
            self._exec._write_inputs(kwargs)
            step = self._fused_train_step()
            self._fused.count_update()
            self._set_outputs(step())
            return
        if self._fused_ready():
            self._fused_train_step()
            self._fused.count_update()
            self._train_fn.apply_grads()
            return
        for i, name in enumerate(self._param_names):
            grad = self._exec.grad_dict.get(name)
            if grad is not None:
                self._updater(i, grad, self._exec.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        self._check_bound()
        if self._pending_batch is not None:
            # outputs before update(): the executor runs this batch's
            # forward and backward, and update() applies its gradients
            kwargs, self._pending_batch = self._pending_batch, None
            self._exec.forward(is_train=True, **kwargs)
            self._exec.backward()
            self._flushed_backward = True
        return self._exec.outputs

    # -- the fused step ----------------------------------------------------------
    def _fused_ready(self):
        return (self._use_fused and self.optimizer_initialized
                and not self.inputs_need_grad
                and type(self._optimizer).apply is not opt.Optimizer.apply
                and all(r in ("write", "null")
                        for r in self._exec.grad_req.values())
                and self._exec._outputs_all_loss_heads())

    def _graphs_on(self):
        """True where the fused step and the inference forward run as
        CUDA graphs: on the card, with no uncapturable op."""
        return (self._use_fused and not self._uncapturable
                and self._context[0].device_type == "gpu")

    def _fused_train_step(self):
        """The training step over the fused state (made at the first
        step, or taken over from another bucket): ``_train_fn``, run by
        ``_train_step`` (its CUDA graph on the card), both made anew
        when the state changed."""
        if self._fused is None:
            pending, self._pending_fused_states = \
                self._pending_fused_states, None
            streams = pending[2] if pending is not None else None
            self._fused = _fs.FusedState(
                self._optimizer, self._context[0].torch_device(),
                base_key=streams["base_key"] if streams else None)
            if pending is not None:
                self._fused.install(*pending)
        if self._train_fn is None or self._train_fn.fused is not self._fused:
            names = [n for n in self._param_names
                     if self._exec.grad_req.get(n, "null") != "null"]
            self._train_fn = _fs.TrainStep(self._exec, self._fused, names)
            self._train_step = self._train_fn
            if self._graphs_on():
                self._train_step = _fs.Graphed(self._train_fn,
                                               self._pool_handle)
        return self._train_step

    def _pool_handle(self):
        """The CUDA graph pool of this module's graphs and of every
        module bound to it with ``shared_module``, made at the first
        capture."""
        owner = self._pool_owner
        if owner._graph_pool is None:
            owner._graph_pool = torch.cuda.graph_pool_handle()
        return owner._graph_pool

    def _set_outputs(self, outs):
        self._exec._train_graph = None
        self._exec.outputs_cache = [NDArray(o, self._context[0])
                                    for o in outs]

    def graph_stats(self):
        """What the fused step and the inference forward run as: whether
        they are CUDA graphs (and the ops that keep them from it), the
        graphs held, the captures made, their time and the pool bytes
        they added."""
        graphs = [g for g in (self._train_step, self._infer_step)
                  if isinstance(g, _fs.Graphed)]
        return {"graphs_on": self._graphs_on(),
                "uncapturable_ops": list(self._uncapturable),
                "graphs": sum(g.graph is not None for g in graphs),
                "captures": sum(g.captures for g in graphs),
                "capture_ms": sum(g.capture_ms for g in graphs),
                "pool_bytes": sum(g.pool_bytes for g in graphs)}

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    # -- checkpoints -------------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and with
        ``save_optimizer_states`` ``prefix-%04d.states``, each written
        atomically."""
        atomic_save(f"{prefix}-symbol.json", self._symbol.save)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        logging.info('Saved checkpoint to "%s"', param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info('Saved optimizer state to "%s"', state_name)

    def save_optimizer_states(self, fname):
        """The fused step's states file (the states by name and the step
        count; the port's random streams beside them, which the JAX
        package ignores), or the ``Updater`` blob on the eager path."""
        if not self.optimizer_initialized:
            raise MXNetError("save_optimizer_states needs init_optimizer")
        payload = self._optimizer_states_to_host()
        if payload["kind"] == "fused":
            blob = dumps({"format": FUSED_STATES_FORMAT,
                          "step": payload["step"],
                          "states": payload["states"],
                          "torch_streams": payload["torch_streams"]})
        else:
            blob = payload["blob"]
        atomic_write_bytes(fname, blob)

    def load_optimizer_states(self, fname):
        """Either states file, written by either package."""
        if not self.optimizer_initialized:
            raise MXNetError("load_optimizer_states needs init_optimizer")
        with open(fname, "rb") as f:
            blob = f.read()
        data = loads(blob)
        if isinstance(data, dict) and \
                data.get("format") == FUSED_STATES_FORMAT:
            self._install_host_states(int(data["step"]), data["states"],
                                      data.get("torch_streams"))
            return
        self._install_updater_blob(blob)

    def _fused_step_count(self):
        if self._fused is not None:
            return self._fused.step_count
        if self._pending_fused_states is not None:
            return self._pending_fused_states[0]
        return 0

    def _install_updater_blob(self, blob):
        """The ``Updater`` blob (keys: parameter indices) into the
        Updater, and for the fused step mapped to names."""
        self._updater.set_states(blob)
        if self._use_fused and self._updater.states:
            by_name = {}
            for i, tree in self._updater.states.items():
                n = i if isinstance(i, str) else (
                    self._param_names[i] if 0 <= i < len(self._param_names)
                    else None)
                if n in self._param_names:
                    by_name[n] = tree
            if by_name:
                self._restore_fused_states(self._fused_step_count(), by_name)

    def _install_host_states(self, step, states_by_name, streams=None):
        """A checkpoint's states by name into the ``Updater`` (host trees,
        placed at their first update; counts at ``step``) and, with the
        fused step, into its state (``_restore_fused_states``)."""
        name2idx = {n: i for i, n in enumerate(self._param_names)}
        self._updater.states = {name2idx[n]: tree
                                for n, tree in states_by_name.items()
                                if n in name2idx}
        for i in self._updater.states:
            self._optimizer._index_update_count[i] = step
        self._optimizer.num_update = max(self._optimizer.num_update, step)
        if self._use_fused:
            self._restore_fused_states(step, states_by_name, streams)

    def _restore_fused_states(self, step, states_by_name, streams=None):
        """Into the fused state at once, or pending until the first
        fused step makes it."""
        self._optimizer._index_update_count[0] = int(step)
        self._optimizer.num_update = max(self._optimizer.num_update,
                                         int(step))
        if self._fused is None:
            self._pending_fused_states = (int(step), dict(states_by_name),
                                          streams)
            return
        self._fused.install(step, states_by_name, streams)

    def _optimizer_states_to_host(self, lazy=False):
        """The optimizer state as a checkpoint payload: ``{"kind":
        "fused", "step", "states", "num_update", "torch_streams"}`` for
        the fused step (made or pending), else ``{"kind": "updater",
        "blob", "num_update"}``.  With ``lazy`` the fused states are
        device copies (no wait for the device; the writer moves them),
        else numpy."""
        if not self.optimizer_initialized:
            raise MXNetError("no optimizer state before init_optimizer")
        num_update = int(self._optimizer.num_update)
        if self._fused is not None:
            d = self._fused.to_host(lazy=lazy)
            return {"kind": "fused", "step": d["step"],
                    "states": d["states"], "num_update": num_update,
                    "torch_streams": d["streams"]}
        if self._pending_fused_states is not None:
            step, states, streams = self._pending_fused_states
            return {"kind": "fused", "step": int(step),
                    "states": to_host_tree(dict(states)),
                    "num_update": num_update, "torch_streams": streams}
        return {"kind": "updater", "blob": self._updater.get_states(),
                "num_update": num_update}

    def _install_optimizer_states(self, payload):
        """The inverse of ``_optimizer_states_to_host``, for either
        package's payload (the JAX package's ``fused_key`` is not
        reproducible here and is ignored)."""
        if not self.optimizer_initialized:
            raise MXNetError("no optimizer state before init_optimizer")
        kind = payload.get("kind")
        if kind == "updater":
            if payload.get("blob"):
                self._install_updater_blob(payload["blob"])
        elif kind == "fused":
            self._install_host_states(int(payload["step"]),
                                      payload["states"],
                                      payload.get("torch_streams"))
        else:
            raise MXNetError(
                f"unknown optimizer-state payload kind {kind!r}")
        nu = payload.get("num_update")
        if nu:
            self._optimizer.num_update = max(self._optimizer.num_update,
                                             int(nu))
