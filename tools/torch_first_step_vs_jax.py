"""One training step of an image network in both packages on the CPU,
each float32 step held against the port's float64 step.

    JAX_PLATFORMS=cpu python tools/torch_first_step_vs_jax.py \
        --network resnet-50 --batch 4

From the JAX ``Module``'s ``Xavier(gaussian, in, 2)`` parameters
(``mx.random.seed(0)``) and one seeded batch of uniform images, each
package takes one ``forward_backward`` in float32 (the JAX ``Module``
on its plain step path, ``MXNET_FUSED_STEP=0``), and the port takes the
same step in float64 (every bound array cast; its ``BatchNorm`` then
keeps float64 statistics).  Prints one JSON line: for each float32 step
its gradients' distance from the float64 step in norm over all weights
(relative to the float64 gradients' norm) and the worst weight's largest
error over its largest float64 value; the distance between the two
float32 steps; the outputs' largest differences; and how many ReLU
decisions (a pre-activation's sign) each float32 training forward takes
otherwise than the float64 one.  Gradients that are zero in float64 up
to rounding (a convolution bias before a BatchNorm) are left out of the
per-weight worst.
"""

import argparse
import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import torch

os.environ.setdefault("MXNET_FUSED_STEP", "0")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import executor as jax_executor  # noqa: E402
from mxnet_tpu import models as jax_models  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import executor as t_executor  # noqa: E402


def relu_signs(outputs, names, relu):
    """{ReLU output name: its positive pattern} of a graph's internals."""
    return {n: np.asarray(o) > 0 for n, o in zip(names, outputs)
            if n in relu}


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--network", default="resnet-50")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--image-shape", default="3,224,224")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--seed", type=int, default=11)
    return p.parse_args()


def main():
    args = parse_args()
    shape = tuple(int(x) for x in args.image_shape.split(","))
    B = args.batch
    kw = dict(num_classes=args.num_classes, image_shape=shape)
    jsym = jax_models.get_symbol(args.network, **kw)
    tsym = mt.models.get_symbol(args.network, **kw)
    binds = dict(data_shapes=[("data", (B,) + shape)],
                 label_shapes=[("softmax_label", (B,))])
    rng = np.random.RandomState(args.seed)
    X = rng.rand(B, *shape).astype(np.float32)
    Y = rng.randint(0, args.num_classes, size=B).astype(np.float32)

    mx.random.seed(0)
    jmod = mx.mod.Module(jsym, context=mx.cpu())
    jmod.bind(**binds)
    jmod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
    arg, aux = jmod.get_params()
    t0 = time.time()
    jmod.forward_backward(mx.io.DataBatch([mx.nd.array(X)],
                                          [mx.nd.array(Y)]))
    names = [n for n in jsym.list_arguments()
             if n not in ("data", "softmax_label")]
    jgrad = {n: jmod._exec.grad_dict[n].asnumpy().astype(np.float64)
             for n in names}
    jout = jmod.get_outputs()[0].asnumpy().astype(np.float64)
    jax_s = time.time() - t0

    def port_step(dtype):
        mod = mt.mod.Module(tsym, context=mt.cpu())
        mod.bind(**binds)
        mod.init_params(arg_params=mt.params_from_numpy(arg, mt.cpu()),
                        aux_params=mt.params_from_numpy(aux, mt.cpu()))
        ex = mod._exec
        if dtype == torch.float64:
            for arrays in (ex.arg_dict, ex.grad_dict, ex.aux_dict):
                for a in arrays.values():
                    a._data = a._data.double()
        mod.forward_backward(mt.io.DataBatch(
            [mt.nd.array(X, ctx=mt.cpu())], [mt.nd.array(Y, ctx=mt.cpu())]))
        return ({n: ex.grad_dict[n]._data.double().numpy() for n in names},
                ex.outputs[0]._data.double().numpy())

    t0 = time.time()
    tgrad, tout = port_step(torch.float32)
    port_s = time.time() - t0
    grad64, out64 = port_step(torch.float64)

    # the training forwards' ReLU decisions against the float64 one's
    internals = {pkg: sym.get_internals() for pkg, sym in ((mx, jsym),
                                                           (mt, tsym))}
    inames = internals[mt].list_outputs()
    relu = {f"{n.name}_output" for n in tsym._topo()
            if n.op == "Activation" and n.attrs.get("act_type") == "relu"}
    host = {k: v.asnumpy() for k, v in arg.items()}
    host.update(data=X, softmax_label=Y)
    haux = {k: v.asnumpy() for k, v in aux.items()}
    jo, _ = jax_executor.build_graph_fn(internals[mx])(
        {k: jnp.asarray(v) for k, v in host.items()},
        {k: jnp.asarray(v) for k, v in haux.items()}, jax.random.PRNGKey(0),
        True)
    signs = {"jax_f32": relu_signs(jo, inames, relu)}
    for label, dt in (("port_f32", torch.float32),
                      ("port_f64", torch.float64)):
        with torch.no_grad():
            to, _ = t_executor.build_graph_fn(internals[mt])(
                {k: torch.from_numpy(v).to(dt) for k, v in host.items()},
                {k: torch.from_numpy(v).to(dt) for k, v in haux.items()},
                0, True)
        signs[label] = relu_signs([t.numpy() for t in to], inames, relu)
    flips = {k: int(sum((signs[k][n] != signs["port_f64"][n]).sum()
                        for n in relu)) for k in ("jax_f32", "port_f32")}

    ref_norm = np.linalg.norm(np.concatenate([grad64[n].ravel()
                                              for n in names]))
    scale = {n: np.abs(grad64[n]).max() for n in names}
    live = [n for n in names if scale[n] > 1e-6 * max(scale.values())]

    def distance(g, ref):
        diff = np.concatenate([(g[n] - ref[n]).ravel() for n in names])
        worst = max(live, key=lambda n: np.abs(g[n] - ref[n]).max()
                    / scale[n])
        return {"norm": float(np.linalg.norm(diff) / ref_norm),
                "worst_weight": worst,
                "worst_rel": float(np.abs(g[worst] - ref[worst]).max()
                                   / scale[worst])}

    print(json.dumps({
        "network": args.network, "batch": B, "image_shape": shape,
        "weights": len(names), "weights_compared_per_weight": len(live),
        "jax_f32_vs_port_f64": distance(jgrad, grad64),
        "port_f32_vs_port_f64": distance(tgrad, grad64),
        "port_f32_vs_jax_f32": distance(tgrad, jgrad),
        "outputs_max_abs": {"jax_f32_vs_port_f64":
                            float(np.abs(jout - out64).max()),
                            "port_f32_vs_port_f64":
                            float(np.abs(tout - out64).max())},
        "relu_decisions": int(sum(signs["port_f64"][n].size for n in relu)),
        "relu_flips_vs_port_f64": flips,
        "jax_step_s_with_compile": jax_s, "port_f32_step_s": port_s,
        "host": "CPU"}))


if __name__ == "__main__":
    main()
