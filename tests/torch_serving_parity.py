"""Shared helpers of the port's serving parity tests
(``test_torch_kvquant.py``, ``test_torch_spec.py``): the tiny LM both
packages serve, the JAX graphs that replay a chain, and the greedy-chain
comparisons.

Greedy chains are compared token for token up to the first position
whose reference top-2 logit margin is at or below the margin given, so
a near-tie decided by summation order cannot decide a test: ``MARGIN``
1e-4 against the JAX full forward for fp32 pages, ``QMARGIN`` 1e-2
against the JAX quantized graphs for int8/fp8 pages (the two packages
quantize K/V their matmuls summed in other orders, ~1e-7 apart, so a
value on a rounding boundary can land one code apart; one code moves a
dequantized element by up to max|x|/127 for int8 or one e4m3 step, 1/8
of the value, for fp8, which moves a logit of this two-layer model by
~1e-3).
"""

import hashlib

import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from mxnet_tpu.executor import build_graph_fn
from mxnet_tpu.models.transformer import (transformer_lm_decode,
                                          transformer_lm_prefill,
                                          transformer_lm_prefix_prefill)
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kv_cache import kv_storage_dtype
from mxnet_tpu_torch.models.transformer import TransformerLM, param_names

V, KVB, L, H, DM, MAXLEN = 61, 4, 2, 2, 32, 32
D = DM // H
TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-4
QMARGIN = 1e-2


def make_lm(seed=0):
    """(host params by name, the port's TransformerLM on the CPU).

    Xavier-uniform weights (factor "in", magnitude 2: the JAX tests'
    initializer) drawn from ``np.random.RandomState(seed)``, so the model
    does not depend on which tests ran before in the process."""
    rng = np.random.RandomState(seed)
    shapes = {"tok_embed_weight": (V, DM), "head_weight": (V, DM)}
    for i in range(L):
        shapes.update({f"layer{i}_qkv_weight": (3 * DM, DM),
                       f"layer{i}_proj_weight": (DM, DM),
                       f"layer{i}_ff1_weight": (4 * DM, DM),
                       f"layer{i}_ff2_weight": (DM, 4 * DM)})
    params = {}
    for n in param_names(L):
        if n in shapes:
            out, fan_in = shapes[n]
            a = np.sqrt(2.0 / fan_in)
            params[n] = rng.uniform(-a, a, (out, fan_in)).astype(np.float32)
        elif n == "pos_embed_weight":
            # values, so a wrong position lookup shows
            params[n] = (rng.randn(MAXLEN, DM) * 0.5).astype(np.float32)
        else:
            width = 3 * DM if "qkv" in n else 4 * DM if "ff1" in n else \
                V if n == "head_bias" else DM
            fill = 1.0 if n.endswith("_gamma") else 0.0
            params[n] = np.full((width,), fill, np.float32)
    port = TransformerLM(mt.params_from_numpy(params, "cpu"), num_layers=L,
                         num_heads=H, kv_block=KVB)
    return params, port


def engine_kw(**over):
    kw = dict(vocab_size=V, num_layers=L, num_heads=H, d_model=DM,
              max_len=MAXLEN, kv_block=KVB, max_streams=4,
              decode_buckets=[1, 2, 4], temperature=0.0)
    kw.update(over)
    return kw


def serve(engine_cls, params, jobs, **over):
    """Submit ``jobs`` [(prompt, max_new)] together; results + stats."""
    with engine_cls(params, **engine_kw(**over)) as eng:
        futs = [eng.submit(p, n) for p, n in jobs]
        outs = [np.asarray(f.result(timeout=300)) for f in futs]
        return outs, eng.stats()


def pool_bytes(x):
    """The raw bytes of a pool from either package, as uint8 numpy."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def fresh_pools(name, P):
    """Empty per-layer pools [k, v, k_scale, v_scale] for int8/fp8 (or
    [k, v] for fp32): (port tensors, JAX arrays) holding the same
    bytes."""
    t = []
    for _ in range(L):
        t += [torch.zeros((P, KVB, H, D), dtype=kv_storage_dtype(name))
              for _ in range(2)]
        if name in ("int8", "fp8"):
            t += [torch.ones((P, KVB, H)), torch.ones((P, KVB, H))]
    np_dt = {"int8": np.int8, "fp8": ml_dtypes.float8_e4m3fn,
             "fp32": np.float32}[name]
    j = [jnp.asarray(p.numpy()) if p.dtype == torch.float32
         else jnp.asarray(pool_bytes(p).view(np_dt)) for p in t]
    return t, j


def jax_graph(sym_fn, host, name, **kw):
    """A JAX serving graph over pools of ``name``, jitted (one compile
    per feed shape): (fn(args) -> outputs, base args)."""
    s = sym_fn(V, num_layers=L, num_heads=H, d_model=DM, kv_block=KVB,
               kv_dtype=name, **kw)
    base = {n: jnp.asarray(host[n]) for n in s.list_arguments()
            if n in host}
    gfn = build_graph_fn(s)
    return jax.jit(lambda a: gfn(a, {}, jax.random.PRNGKey(0), False)[0]), \
        base


def run_graph(graph, feeds, pools):
    """One call of a ``jax_graph``: (logits, new pools)."""
    fn, base = graph
    stride = len(pools) // L
    names = ("kpool", "vpool", "kscale", "vscale")[:stride]
    a = dict(base)
    a.update({k: jnp.asarray(v) for k, v in feeds.items()})
    for i in range(L):
        for j, nm in enumerate(names):
            a[f"layer{i}_{nm}"] = pools[stride * i + j]
    outs = fn(a)
    return np.asarray(outs[0]), list(outs[1:])


def jax_quant_chain_rows(host, name, prompt, gen, P=14, chunk=0,
                         cached=0):
    """Logit rows the JAX quantized serving graphs give along the chain
    prompt + gen, on the path the engine takes: row i predicts gen[i].

    The prompt's pages are written by one whole-prompt prefill, or, with
    ``chunk`` and a prompt longer than it, by suffix prefills
    (``transformer_lm_prefix_prefill``) of ``chunk`` tokens each.  With
    ``cached`` (block-aligned) the chain is a later request of the same
    prompt that found ``cached`` tokens in the prefix cache: its first
    row comes from a suffix prefill of the rest, or, when the whole
    prompt was cached (a full hit), from a decode step replaying the
    last prompt token.  The other rows are decode steps."""
    pre = jax_graph(transformer_lm_prefill, host, name, paged=True)
    dec = jax_graph(transformer_lm_decode, host, name, paged=True)
    sp = jax_graph(transformer_lm_prefix_prefill, host, name)
    _, pools = fresh_pools(name, P)
    n = len(prompt)
    table = np.arange(1, P, dtype=np.int32)[
        None, :(n + len(gen) + KVB) // KVB]

    def suffix(a, b, pools):
        ts = -(-(b - a) // KVB) * KVB
        tokens = np.zeros((1, ts), np.int32)
        tokens[0, :b - a] = prompt[a:b]
        return run_graph(sp, dict(
            data=tokens, positions=(a + np.arange(ts, dtype=np.int32))[None],
            start=np.array([a], np.int32), lengths=np.array([b], np.int32),
            block_table=table), pools)

    def decode(tok, pos, pools):
        return run_graph(dec, dict(
            data=np.array([[tok]], np.int32),
            positions=np.array([[pos]], np.int32),
            lengths=np.array([pos + 1], np.int32), block_table=table),
            pools)

    if chunk and n > chunk:
        for a in range(0, n, chunk):
            logits, pools = suffix(a, min(a + chunk, n), pools)
        last = logits[0, n - 1 - a]
    else:
        tp = -(-n // KVB) * KVB
        tokens = np.zeros((1, tp), np.int32)
        tokens[0, :n] = prompt
        logits, pools = run_graph(pre, dict(
            data=tokens, positions=np.arange(tp, dtype=np.int32)[None],
            lengths=np.array([n], np.int32),
            block_table=table[:, :tp // KVB]), pools)
        last = logits[0, n - 1]
    if cached == n:
        logits, pools = decode(prompt[-1], n - 1, pools)
        last = logits[0, 0]
    elif cached:
        logits, pools = suffix(cached, n, pools)
        last = logits[0, n - 1 - cached]
    rows = [last]
    for i, tok in enumerate(gen[:-1]):
        logits, pools = decode(tok, n + i, pools)
        rows.append(logits[0, 0])
    return np.stack(rows)


_FULL = {}


def jax_full_rows(host, prompt, gen):
    """Logit rows of the JAX full causal forward (the parameters' dtype)
    along prompt + gen: row i predicts gen[i].  One jitted forward over
    ``MAXLEN`` positions (causality keeps the padded tail out of the
    rows read); rows cached by the parameters' bytes and the chain."""
    if "fn" not in _FULL:
        s = transformer_lm_prefill(V, num_layers=L, num_heads=H, d_model=DM,
                                   kv_block=KVB, paged=False)
        gfn = build_graph_fn(s)
        _FULL["names"] = [n for n in s.list_arguments()
                          if n not in ("data", "positions", "lengths")]
        _FULL["fn"] = jax.jit(
            lambda a: gfn(a, {}, jax.random.PRNGKey(0), False)[0][0][0])
    seq = np.concatenate([prompt, gen]).astype(np.int32)
    params = [np.asarray(host[n]) for n in _FULL["names"]]
    key = (hashlib.sha256(b"".join(p.tobytes() for p in params)).digest(),
           tuple(str(p.dtype) for p in params), seq.tobytes(), len(prompt))
    if key not in _FULL:
        data = np.zeros((1, MAXLEN), np.int32)
        data[0, :len(seq)] = seq
        a = {n: jnp.asarray(p) for n, p in zip(_FULL["names"], params)}
        a.update(data=jnp.asarray(data),
                 positions=jnp.asarray(np.arange(MAXLEN,
                                                 dtype=np.int32)[None]),
                 lengths=jnp.asarray(np.asarray([MAXLEN], np.int32)))
        rows = np.asarray(_FULL["fn"](a))
        _FULL[key] = rows[len(prompt) - 1:len(seq) - 1]
    return _FULL[key]


def assert_chains_agree(host, jobs, ref_outs, outs, name="fp32",
                        paths=None):
    """Greedy chains ``outs`` equal the JAX engine's ``ref_outs`` up to
    each chain's first reference near-tie (MARGIN against the full
    forward for fp32 pages, QMARGIN against the quantized graphs for
    int8/fp8, along each job's path: ``paths`` holds one dict of
    ``jax_quant_chain_rows``'s ``chunk``/``cached`` a job); at least
    half of all tokens are compared."""
    compared, total = 0, sum(len(r) for r in ref_outs)
    paths = paths or [{}] * len(jobs)
    for (prompt, _), ref, got, path in zip(jobs, ref_outs, outs, paths):
        assert len(ref) == len(got)
        if name == "fp32":
            rows, margin = jax_full_rows(host, prompt, ref), MARGIN
        else:
            rows, margin = jax_quant_chain_rows(host, name, prompt, ref,
                                                **path), QMARGIN
        for i in range(len(ref)):
            top2 = np.sort(rows[i])[-2:]
            if top2[1] - top2[0] <= margin:
                break  # a near-tie: later tokens condition on it
            assert int(np.argmax(rows[i])) == ref[i]
            assert got[i] == ref[i], (name, prompt, i, ref, got)
            compared += 1
    assert compared * 2 >= total, (compared, total)


def repetitive_prompt(rng, n=18, motif=5):
    """A prompt that repeats a random motif: where prompt lookup hits."""
    m = rng.randint(1, V, size=motif).astype(np.int32)
    return np.tile(m, -(-n // motif))[:n]


class OracleProposer:
    """Drafts each prompt's known greedy continuation (so drafts are
    accepted), with draft ``wrong_at`` made wrong whenever the context
    length is a multiple of ``wrong_every`` (so some are rejected): a
    deterministic function of the context, as a proposer must be.  The
    n-gram proposer rarely hits on a random-weight model's output."""

    def __init__(self, jobs, chains, wrong_every=3, wrong_at=-1):
        self.seqs = [(len(p), np.concatenate([p, c]).astype(np.int32))
                     for (p, _), c in zip(jobs, chains)]
        self.wrong_every = wrong_every
        self.wrong_at = wrong_at

    def propose(self, ctx, k):
        ctx = np.asarray(ctx, np.int32)
        for plen, seq in self.seqs:
            if plen <= len(ctx) <= len(seq) \
                    and np.array_equal(seq[:len(ctx)], ctx):
                d = seq[len(ctx):len(ctx) + k].copy()
                if d.size and len(ctx) % self.wrong_every == 0:
                    i = min(self.wrong_at, d.size - 1)
                    d[i] = (d[i] + 1) % V
                return d
        return np.empty(0, np.int32)


# the paged kernels' work-partition edges at this size (test_torch_spec.py,
# test_torch_kvquant.py): head widths, window rows, table pages, lengths
EDGE_D = (32, 48, 128)
EDGE_W = (1, 2, 9)
EDGE_MB = 6
EDGE_LENGTHS = (0, 1, KVB - 1, KVB, KVB + 1, 2 * KVB, EDGE_MB * KVB)


def edge_tables(lengths, seed):
    """Fragmented block tables (padded with the scratch page 0) holding
    ``lengths`` tokens a stream, and the pool's page count."""
    rng = np.random.RandomState(seed)
    B = len(lengths)
    pages = rng.permutation(np.arange(1, 1 + B * EDGE_MB)).astype(np.int32)
    table = np.zeros((B, EDGE_MB), np.int32)
    used = 0
    for i, n in enumerate(lengths):
        k = -(-int(n) // KVB)
        table[i, :k] = pages[used:used + k]
        used += k
    return table, 1 + B * EDGE_MB


def edge_verify_starts(W):
    """Starts on page boundaries (0, KVB, 2 KVB), one whose window ends a
    token short of the table's last slot, and a padded batch row (start
    0 over scratch pages, the last)."""
    return np.array([0, KVB, 2 * KVB, EDGE_MB * KVB - W - 1, 0], np.int32)
