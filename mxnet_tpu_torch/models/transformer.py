"""Decoder-only transformer LM: the training symbol ``transformer_lm``
and the serving forms.

Counterpart of ``mxnet_tpu/models/transformer.py``.  ``transformer_lm``
(``:49-147``) is the training symbol, built from the port's registered
ops with the JAX package's parameter names, for ``Module``.  The JAX
package's serving symbols (``_decode_block``, ``_lm_trunk``,
``transformer_lm_prefill`` / ``_prefix_prefill`` / ``_verify`` /
``_decode``) are here too, over the port's serving ops, for users who
bind them (``simple_bind``, ``Predictor``); ``DecodeEngine`` runs the
same chains of ops on one ``nn.Module``, ``TransformerLM``:

* ``prefill`` — the causal forward over a (padded) prompt that also
  writes every layer's K/V into the paged pools;
* ``suffix_prefill`` — the forward over the uncached suffix of a prompt
  whose first ``start`` tokens are cached (a prefix-cache hit, or one
  chunk of a chunked prefill), attending the cached pages;
* ``decode`` — one token per stream against the paged pools;
* ``verify`` — the speculative verify step: W = 1 + k tokens per stream
  against the paged pools, one logits row per token;
* ``forward`` — the full causal forward over whole sequences, what
  prefill plus decode steps are checked against.

Pools are raw fp32/bf16 ``[k, v]`` per layer or, quantized (int8 /
float8_e4m3fn codes), ``[k, v, k_scale, v_scale]`` per layer: the JAX
engine's pool stride 2 or 4.

Parameter names are the training symbol's argument names
(``tok_embed_weight``, ``layer{i}_qkv_weight``, ..., ``head_bias``), so
one checkpoint dict binds to both packages.  Pre-LN residual blocks,
learned positions, exact-erf GELU.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from .. import symbol as sym
from ..attribute import AttrScope
from ..base import MXNetError
from ..ops import attention as att
from ..ops.adapter import lora_gather_delta
from ..ops.indexing import embedding, take
from ..ops.nn import fully_connected, gelu, layer_norm

__all__ = ["TransformerLM", "param_names", "transformer_lm",
           "logical_axes", "kv_pool_var", "kv_scale_var",
           "transformer_lm_prefill", "transformer_lm_prefix_prefill",
           "transformer_lm_verify", "transformer_lm_decode"]

_QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)

_LAYER_PARAMS = ("ln1_gamma", "ln1_beta", "qkv_weight", "qkv_bias",
                 "proj_weight", "proj_bias", "ln2_gamma", "ln2_beta",
                 "ff1_weight", "ff1_bias", "ff2_weight", "ff2_bias")


def param_names(num_layers: int) -> List[str]:
    """Parameter names of a ``num_layers`` LM, in symbol order."""
    names = ["tok_embed_weight", "pos_embed_weight"]
    for i in range(num_layers):
        names += [f"layer{i}_{p}" for p in _LAYER_PARAMS]
    return names + ["ln_f_gamma", "ln_f_beta", "head_weight", "head_bias"]


def logical_axes(*names: Optional[str]) -> Dict[str, str]:
    """Attr dict naming a Variable's logical axes, one entry per dim
    (``None`` = never partitioned); the port's copy of
    ``mxnet_tpu.parallel.logical_axes``, kept so the symbols carry the
    same attrs."""
    return {"__logical__": ",".join("-" if n is None else str(n)
                                    for n in names)}


def _block(x, d_model, num_heads, d_ff, name, causal, dropout, block_size):
    # attention sublayer (pre-LN); the fused QKV projection feeds
    # QKVSelfAttention directly, no reshapes between the two matmuls
    h = sym.LayerNorm(x, name=f"{name}_ln1")
    qkv = sym.FullyConnected(
        h, num_hidden=3 * d_model, flatten=False, name=f"{name}_qkv",
        weight=sym.Variable(f"{name}_qkv_weight",
                            attr=logical_axes("qkv", "embed")),
        bias=sym.Variable(f"{name}_qkv_bias", attr=logical_axes("qkv")))
    a = sym.QKVSelfAttention(qkv, num_heads=num_heads, causal=causal,
                             block_size=block_size, name=f"{name}_attn")
    a = sym.FullyConnected(
        a, num_hidden=d_model, flatten=False, name=f"{name}_proj",
        weight=sym.Variable(f"{name}_proj_weight",
                            attr=logical_axes("embed", "heads")),
        bias=sym.Variable(f"{name}_proj_bias", attr=logical_axes("embed")))
    if dropout > 0:
        a = sym.Dropout(a, p=dropout, name=f"{name}_attn_drop")
    x = x + a
    # feed-forward sublayer (pre-LN, GELU)
    h = sym.LayerNorm(x, name=f"{name}_ln2")
    h = sym.FullyConnected(
        h, num_hidden=d_ff, flatten=False, name=f"{name}_ff1",
        weight=sym.Variable(f"{name}_ff1_weight",
                            attr=logical_axes("ffn", "embed")),
        bias=sym.Variable(f"{name}_ff1_bias", attr=logical_axes("ffn")))
    h = sym.Activation(h, act_type="gelu", name=f"{name}_gelu")
    h = sym.FullyConnected(
        h, num_hidden=d_model, flatten=False, name=f"{name}_ff2",
        weight=sym.Variable(f"{name}_ff2_weight",
                            attr=logical_axes("embed", "ffn")),
        bias=sym.Variable(f"{name}_ff2_bias", attr=logical_axes("embed")))
    if dropout > 0:
        h = sym.Dropout(h, p=dropout, name=f"{name}_ff_drop")
    return x + h


def transformer_lm(vocab_size, seq_len, num_layers=4, num_heads=4,
                   d_model=128, d_ff=None, causal=True, dropout=0.0,
                   block_size=0, dtype="float32", head="softmax"):
    """Token ids (B, T) → SoftmaxOutput probabilities (B, T, vocab), or
    per-token cross entropy (B, T) with ``head="ce"`` (the fused
    SoftmaxCELoss head, the one for 32k+ vocabularies).  Labels are
    next-token ids (B, T); id 0 is ignored.  Pre-LN blocks, learned
    positions (``pos_embed_weight`` starts at zero), exact-erf GELU.
    ``dropout > 0`` drops the attention projection's and the
    feed-forward's outputs before their residual adds
    (``layer{i}_attn_drop``, ``layer{i}_ff_drop``), never inside
    attention.

    ``dtype`` is the network's compute dtype: the token ids and
    ``tok_embed_weight`` stay float32 (bfloat16 holds no id above 256
    exactly), a ``Cast`` after the embedding (``embed_cast``) and the
    typed ``pos_embed_weight`` type every later layer, and binding infers
    every other parameter in ``dtype``."""
    if d_model % num_heads:
        raise ValueError(f"d_model {d_model} % num_heads {num_heads} != 0")
    if head not in ("ce", "softmax"):
        raise MXNetError(f"transformer_lm: head {head!r} (ce or softmax)")
    d_ff = d_ff or 4 * d_model
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    x = sym.Embedding(data, input_dim=vocab_size, output_dim=d_model,
                      name="tok_embed",
                      weight=sym.Variable(
                          "tok_embed_weight",
                          attr=logical_axes("vocab", "embed")))
    if dtype != "float32":
        x = sym.Cast(x, dtype=dtype, name="embed_cast")
    pos = sym.Variable("pos_embed_weight", shape=(seq_len, d_model),
                       dtype=dtype, init="[\"zero\", {}]",
                       attr=logical_axes("length", "embed"))
    x = sym.broadcast_add(x, sym.expand_dims(pos, axis=0),
                          attr={"__logical__": "batch,length,embed"})
    for i in range(num_layers):
        with AttrScope(__pp_block__=str(i)):
            x = _block(x, d_model, num_heads, d_ff, f"layer{i}", causal,
                       dropout, block_size)
    x = sym.LayerNorm(x, name="ln_f")
    logits = sym.FullyConnected(
        x, num_hidden=vocab_size, flatten=False, name="head",
        weight=sym.Variable("head_weight",
                            attr=logical_axes("vocab", "embed")),
        bias=sym.Variable("head_bias", attr=logical_axes("vocab")))
    if head == "ce":
        return sym.SoftmaxCELoss(logits, label, use_ignore=True,
                                 ignore_label=0, name="softmax")
    return sym.SoftmaxOutput(logits, label, preserve_shape=True,
                             ignore_label=0, use_ignore=True,
                             name="softmax")


# ---------------------------------------------------------------------------
# The serving symbols (``mxnet_tpu/models/transformer.py:171-454``): the
# same argument names, outputs and attributes as the JAX package's, so a
# trained checkpoint binds to them without renaming and either package's
# JSON loads in the other.  They take ``positions`` (B, S) as an input,
# so one symbol serves every (batch, length) bucket.  The pools are
# written in place by the serving ops, which return them as the cache
# outputs.
# ---------------------------------------------------------------------------


def _decode_block(x, d_model, num_heads, d_ff, name, kv_block, attend,
                  lora=(), layer=0):
    """One pre-LN block with the attention sublayer replaced by
    ``attend(qkv) -> (att_out, cache_outs)``; ``lora`` (rank buckets)
    chains one ``LoraGatherDelta`` epilogue a bucket on the fused QKV
    projection (slot 0 is the base bits; an empty tuple builds the
    pre-adapter graph)."""
    h = sym.LayerNorm(x, name=f"{name}_ln1")
    qkv = sym.FullyConnected(
        h, num_hidden=3 * d_model, flatten=False, name=f"{name}_qkv",
        weight=sym.Variable(f"{name}_qkv_weight",
                            attr=logical_axes("qkv", "embed")),
        bias=sym.Variable(f"{name}_qkv_bias", attr=logical_axes("qkv")))
    for rb in (lora or ()):
        qkv = sym.LoraGatherDelta(
            qkv, h, sym.Variable(f"adapter_a_r{rb}"),
            sym.Variable(f"adapter_b_r{rb}"),
            sym.Variable(f"adapter_slots_r{rb}"),
            layer=layer, name=f"{name}_lora_r{rb}")
    a, cache_outs = attend(qkv)
    a = sym.FullyConnected(
        a, num_hidden=d_model, flatten=False, name=f"{name}_proj",
        weight=sym.Variable(f"{name}_proj_weight",
                            attr=logical_axes("embed", "heads")),
        bias=sym.Variable(f"{name}_proj_bias", attr=logical_axes("embed")))
    x = x + a
    h = sym.LayerNorm(x, name=f"{name}_ln2")
    h = sym.FullyConnected(
        h, num_hidden=d_ff, flatten=False, name=f"{name}_ff1",
        weight=sym.Variable(f"{name}_ff1_weight",
                            attr=logical_axes("ffn", "embed")),
        bias=sym.Variable(f"{name}_ff1_bias", attr=logical_axes("ffn")))
    h = sym.Activation(h, act_type="gelu", name=f"{name}_gelu")
    h = sym.FullyConnected(
        h, num_hidden=d_model, flatten=False, name=f"{name}_ff2",
        weight=sym.Variable(f"{name}_ff2_weight",
                            attr=logical_axes("embed", "ffn")),
        bias=sym.Variable(f"{name}_ff2_bias", attr=logical_axes("embed")))
    return x + h, cache_outs


def kv_pool_var(name: str):
    """A KV value-pool Variable (P, KVB, H, D), 'heads' its logical
    shard axis."""
    return sym.Variable(name, attr=logical_axes(None, None, "heads", None))


def kv_scale_var(name: str):
    """A quantized pool's (P, KVB, H) float32 scale Variable."""
    return sym.Variable(name, attr=logical_axes(None, None, "heads"))


def _lm_trunk(num_layers, num_heads, d_model, d_ff, kv_block, attend_for,
              vocab_size, lora=None):
    """Embedding → blocks → ln_f → head logits, layer i's attention from
    ``attend_for(i)``; outputs ``[logits] + caches``."""
    d_ff = d_ff or 4 * d_model
    data = sym.Variable("data")
    positions = sym.Variable("positions")
    x = sym.Embedding(data, input_dim=vocab_size, output_dim=d_model,
                      name="tok_embed",
                      weight=sym.Variable(
                          "tok_embed_weight",
                          attr=logical_axes("vocab", "embed")))
    pos = sym.Variable("pos_embed_weight",
                       attr=logical_axes("length", "embed"))
    x = x + sym.take(pos, positions, name="pos_lookup")
    caches = []
    for i in range(num_layers):
        x, cache_outs = _decode_block(x, d_model, num_heads, d_ff,
                                      f"layer{i}", kv_block, attend_for(i),
                                      lora=lora, layer=i)
        caches.extend(cache_outs)
    x = sym.LayerNorm(x, name="ln_f")
    logits = sym.FullyConnected(
        x, num_hidden=vocab_size, flatten=False, name="head",
        weight=sym.Variable("head_weight",
                            attr=logical_axes("vocab", "embed")),
        bias=sym.Variable("head_bias", attr=logical_axes("vocab")))
    return sym.Group([logits] + caches)


def _kv_quant(kv_dtype) -> bool:
    from ..kv_cache import KV_DTYPES, kv_quantized

    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r} not in {KV_DTYPES}")
    return kv_quantized(kv_dtype)


def _pool_vars(i, quant):
    """Layer i's pool Variables: [k, v] or [k, v, k_scale, v_scale]."""
    out = [kv_pool_var(f"layer{i}_kpool"), kv_pool_var(f"layer{i}_vpool")]
    if quant:
        out += [kv_scale_var(f"layer{i}_kscale"),
                kv_scale_var(f"layer{i}_vscale")]
    return out


def transformer_lm_prefill(vocab_size, num_layers=4, num_heads=4,
                           d_model=128, d_ff=None, kv_block=16,
                           paged=True, kv_dtype="fp32", lora=None):
    """Prefill symbol: the causal forward over a (padded) prompt that
    also writes each layer's K/V into the cache.  Inputs ``data`` /
    ``positions`` (B, T), ``lengths`` (B,), and, paged, ``block_table``
    (B, MB) and the per-layer pools (``layer{i}_kpool`` / ``_vpool``,
    with ``_kscale`` / ``_vscale`` for int8/fp8).  Outputs ``[logits
    (B, T, vocab)] + caches`` (unpaged: each layer's (B, T, H, D) key
    and value).  Attention at ``block_size = kv_block``."""
    lengths = sym.Variable("lengths")
    quant = _kv_quant(kv_dtype)

    def attend_for(i):
        def attend(qkv):
            a = sym.QKVSelfAttentionPrefill(
                qkv, num_heads=num_heads, block_size=kv_block,
                name=f"layer{i}_attn")
            out, k, v = a[0], a[1], a[2]
            if not paged:
                return out, [k, v]
            pools = _pool_vars(i, quant)
            op = sym.PagedCacheWriteQ if quant else sym.PagedCacheWrite
            w = op(k, v, *pools, sym.Variable("block_table"), lengths,
                   name=f"layer{i}_cache_write")
            return out, [w[j] for j in range(len(pools))]
        return attend

    return _lm_trunk(num_layers, num_heads, d_model, d_ff, kv_block,
                     attend_for, vocab_size, lora=lora)


def _window_symbol(op, op_q, vocab_size, num_layers, num_heads, d_model,
                   d_ff, kv_block, kv_dtype, lora):
    """The trunk over a window op taking ``start`` and ``lengths`` (the
    suffix prefill's and the verify step's)."""
    lengths = sym.Variable("lengths")
    start = sym.Variable("start")
    quant = _kv_quant(kv_dtype)

    def attend_for(i):
        def attend(qkv):
            pools = _pool_vars(i, quant)
            a = (op_q if quant else op)(
                qkv, *pools, sym.Variable("block_table"), start, lengths,
                num_heads=num_heads, name=f"layer{i}_attn")
            return a[0], [a[j + 1] for j in range(len(pools))]
        return attend

    return _lm_trunk(num_layers, num_heads, d_model, d_ff, kv_block,
                     attend_for, vocab_size, lora=lora)


def transformer_lm_prefix_prefill(vocab_size, num_layers=4, num_heads=4,
                                  d_model=128, d_ff=None, kv_block=16,
                                  kv_dtype="fp32", lora=None):
    """Suffix-prefill symbol for a prefix-cache hit or a chunk: the
    forward over the uncached suffix only.  Inputs ``data`` /
    ``positions`` (B, Ts) at positions ``start[b] + i``, ``start`` (B,)
    cached (block-aligned) tokens, ``lengths`` (B,) total tokens,
    ``block_table`` (B, MB) covering prefix and suffix pages, the
    per-layer pools.  Outputs ``[suffix logits (B, Ts, vocab)] +
    caches``."""
    return _window_symbol(sym.QKVPagedPrefillAttend,
                          sym.QKVPagedPrefillAttendQ, vocab_size,
                          num_layers, num_heads, d_model, d_ff, kv_block,
                          kv_dtype, lora)


def transformer_lm_verify(vocab_size, num_layers=4, num_heads=4,
                          d_model=128, d_ff=None, kv_block=16,
                          kv_dtype="fp32", lora=None):
    """Speculative-verify symbol: W = 1 + k tokens a stream at positions
    ``start[b] + i`` against the paged cache.  Inputs ``data`` /
    ``positions`` (B, W), ``start`` (B,), ``lengths`` (B,) (``start`` +
    live window rows), ``block_table``, the per-layer pools.  Outputs
    ``[logits (B, W, vocab)] + caches``; row i equals the decode step at
    length ``start + 1 + i`` over the same cache bytes."""
    return _window_symbol(sym.QKVPagedVerifyAttend,
                          sym.QKVPagedVerifyAttendQ, vocab_size, num_layers,
                          num_heads, d_model, d_ff, kv_block, kv_dtype,
                          lora)


def transformer_lm_decode(vocab_size, num_layers=4, num_heads=4,
                          d_model=128, d_ff=None, kv_block=16,
                          paged=True, kv_dtype="fp32", lora=None):
    """Decode symbol: one token a stream against the KV cache.  Inputs
    ``data`` / ``positions`` (B, 1), ``lengths`` (B,) counting the
    current token, and, paged, ``block_table`` and the per-layer pools,
    or, contiguous, ``layer{i}_kcache`` / ``_vcache`` (B, C, H, D).
    Outputs ``[logits (B, 1, vocab)] + caches``."""
    lengths = sym.Variable("lengths")
    quant = _kv_quant(kv_dtype)

    def attend_for(i):
        def attend(qkv):
            if paged:
                pools = _pool_vars(i, quant)
                op = sym.QKVPagedAttentionDecodeQ if quant \
                    else sym.QKVPagedAttentionDecode
                a = op(qkv, *pools, sym.Variable("block_table"), lengths,
                       num_heads=num_heads, name=f"layer{i}_attn")
                return a[0], [a[j + 1] for j in range(len(pools))]
            a = sym.QKVSelfAttentionDecode(
                qkv, sym.Variable(f"layer{i}_kcache"),
                sym.Variable(f"layer{i}_vcache"), lengths,
                num_heads=num_heads, block_size=kv_block,
                name=f"layer{i}_attn")
            return a[0], [a[1], a[2]]
        return attend

    return _lm_trunk(num_layers, num_heads, d_model, d_ff, kv_block,
                     attend_for, vocab_size, lora=lora)


class TransformerLM(nn.Module):
    """The LM over a dict of parameter tensors (see ``params_from_numpy``).

    ``kv_block`` is the cache page size and the plain attention's block
    size (the JAX graphs' ``block_size=kv_block``).  Pools are passed as
    a flat list ``[k_0, v_0, k_1, v_1, ...]`` of (P, KVB, H, D) tensors
    or, for int8/fp8 pages, ``[k_0, v_0, ks_0, vs_0, ...]`` with
    (P, KVB, H) float32 scales, and are written in place.

    ``lora`` (rank buckets, the JAX graphs' ``lora=``): the serving entry
    points take ``adapter``, per bucket in this order an (a_slab, b_slab,
    slots) triple (``AdapterPool.slabs()`` and the batch's (B,) slot
    ids), as runtime arguments; each bucket applies one
    ``lora_gather_delta`` epilogue after the fused QKV projection,
    chained as ``_decode_block`` chains them
    (``mxnet_tpu/models/transformer.py:188-195``: a stream sits in one
    bucket, slot 0 in the others).  A bucket whose slots are None (no
    stream of the batch in it) is skipped, which the where-select makes
    exact; an empty ``adapter`` runs the pre-adapter ops."""

    def __init__(self, params: Dict[str, torch.Tensor], *, num_layers: int,
                 num_heads: int, kv_block: int = 16, lora=()):
        super().__init__()
        names = param_names(num_layers)
        missing = [n for n in names if n not in params]
        if missing:
            raise MXNetError(f"params missing {missing} for a "
                             f"{num_layers}-layer transformer_lm")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.kv_block = int(kv_block)
        self.lora = tuple(int(r) for r in lora or ())
        d_model = params["tok_embed_weight"].shape[1]
        if d_model % self.num_heads:
            raise MXNetError(f"d_model {d_model} % num_heads "
                             f"{self.num_heads} != 0")
        for n in names:
            self.register_parameter(
                n, nn.Parameter(params[n], requires_grad=False))

    def _p(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def _epilogues(self, adapter) -> List[tuple]:
        """The (a_slab, b_slab, slots) triples of ``adapter`` whose
        bucket holds a stream of the batch."""
        if not adapter:
            return []
        if len(adapter) != 3 * len(self.lora):
            raise MXNetError(
                f"adapter: {len(adapter)} arguments; the model's rank "
                f"buckets {self.lora} take an (a_slab, b_slab, slots) "
                f"triple each")
        return [tuple(adapter[3 * j:3 * j + 3])
                for j in range(len(self.lora))
                if adapter[3 * j + 2] is not None]

    def _trunk(self, data, positions,
               attend: Callable[[int, torch.Tensor], torch.Tensor],
               adapter=()):
        """Embedding → blocks → ln_f → head logits (float32); layer i's
        attention sublayer is ``attend(i, qkv) -> (B, S, H*D)``, after
        the ``adapter`` epilogues on its QKV projection.  The
        blocks run in ``pos_embed_weight``'s dtype, as the training
        symbol's ``embed_cast`` makes them run (the embedding, float32,
        is cast to it): a bf16 LM's attention meets B1's and the paged
        kernels' bf16 instantiations."""
        pos = self._p("pos_embed_weight")
        x = embedding(data, self._p("tok_embed_weight")).to(pos.dtype) \
            + take(pos, positions)
        epilogues = self._epilogues(adapter)
        for i in range(self.num_layers):
            p = f"layer{i}_"
            h = layer_norm(x, self._p(p + "ln1_gamma"),
                           self._p(p + "ln1_beta"))
            qkv = fully_connected(h, self._p(p + "qkv_weight"),
                                  self._p(p + "qkv_bias"))
            for a_slab, b_slab, slots in epilogues:
                qkv = lora_gather_delta(qkv, h, a_slab, b_slab, slots, i)
            a = attend(i, qkv)
            x = x + fully_connected(a, self._p(p + "proj_weight"),
                                    self._p(p + "proj_bias"))
            h = layer_norm(x, self._p(p + "ln2_gamma"),
                           self._p(p + "ln2_beta"))
            h = gelu(fully_connected(h, self._p(p + "ff1_weight"),
                                     self._p(p + "ff1_bias")))
            x = x + fully_connected(h, self._p(p + "ff2_weight"),
                                    self._p(p + "ff2_bias"))
        x = layer_norm(x, self._p("ln_f_gamma"), self._p("ln_f_beta"))
        return fully_connected(x, self._p("head_weight"),
                               self._p("head_bias")).float()

    def _check_pools(self, pools: Sequence[torch.Tensor]) -> int:
        """The pool stride: 2 ([k, v] a layer) or, for int8/fp8 codes,
        4 ([k, v, k_scale, v_scale] a layer)."""
        stride = 4 if pools and pools[0].dtype in _QUANT_DTYPES else 2
        if len(pools) != stride * self.num_layers:
            form = "[k_0, v_0, ks_0, vs_0, ...]" if stride == 4 \
                else "[k_0, v_0, ...]"
            raise MXNetError(f"expected {stride * self.num_layers} pools "
                             f"{form}; got {len(pools)}")
        return stride

    @torch.no_grad()
    def prefill(self, data, positions, lengths, block_table,
                pools: Sequence[torch.Tensor], adapter=()) -> torch.Tensor:
        """data/positions (B, T) int, lengths (B,) int32 prompt lengths,
        block_table (B, MB) int32 → logits (B, T, vocab); every layer's
        K/V of rows < lengths lands in its pools (padding rows on the
        scratch page).  Attention reads the raw K/V; quantized pools
        only receive codes and scales."""
        st = self._check_pools(pools)

        def attend(i, qkv):
            out, k, v = att.qkv_self_attention_prefill(
                qkv, self.num_heads, block_size=self.kv_block)
            if st == 4:
                att.paged_prefill_write_q(k, v, *pools[4 * i:4 * i + 4],
                                          block_table, lengths)
            else:
                att.paged_prefill_write(k, v, pools[2 * i],
                                        pools[2 * i + 1], block_table,
                                        lengths)
            return out

        return self._trunk(data, positions, attend, adapter)

    @torch.no_grad()
    def suffix_prefill(self, data, positions, start, lengths,
                       block_table, pools: Sequence[torch.Tensor],
                       adapter=()) -> torch.Tensor:
        """The counterpart of ``transformer_lm_prefix_prefill``:
        data/positions (B, Ts) int hold the uncached suffix at positions
        ``start[b] + i``; ``start`` (B,) int32 (or an int for every row,
        block-aligned) the tokens each row has cached; lengths (B,) int32
        the total tokens (start + the real suffix); block_table (B, MB)
        int32 covering the prefix and suffix pages → logits (B, Ts,
        vocab) of the suffix rows.  Every layer writes the suffix's K/V
        into its pools (quantized pools quantize on write), then attends
        the table's pages under the key limit ``start`` and the raw
        suffix, two launches of the ``flash_attention_partial`` kernel
        (``ops.attention.prefix_suffix_attention``)."""
        st = self._check_pools(pools)

        def attend(i, qkv):
            if st == 4:
                return att.qkv_paged_prefill_attend_q(
                    qkv, *pools[4 * i:4 * i + 4], block_table, start,
                    lengths, self.num_heads)
            return att.qkv_paged_prefill_attend(
                qkv, pools[2 * i], pools[2 * i + 1], block_table, start,
                lengths, self.num_heads)

        return self._trunk(data, positions, attend, adapter)

    @torch.no_grad()
    def decode(self, data, positions, lengths, block_table,
               pools: Sequence[torch.Tensor], adapter=()) -> torch.Tensor:
        """One token per stream: data/positions (B, 1), lengths (B,)
        int32 counting the current token (0 = padded slot), block_table
        (B, MB) int32 → logits (B, 1, vocab); the token's K/V is written
        into the pools first."""
        st = self._check_pools(pools)

        def attend(i, qkv):
            if st == 4:
                return att.qkv_paged_attention_decode_q(
                    qkv, *pools[4 * i:4 * i + 4], block_table, lengths,
                    self.num_heads)
            out, _, _ = att.qkv_paged_attention_decode(
                qkv, pools[2 * i], pools[2 * i + 1], block_table, lengths,
                self.num_heads)
            return out

        return self._trunk(data, positions, attend, adapter)

    @torch.no_grad()
    def verify(self, data, positions, start, lengths, block_table,
               pools: Sequence[torch.Tensor], adapter=()) -> torch.Tensor:
        """The speculative verify step: data/positions (B, W) hold the
        pending token and the drafts at positions ``start[b] + w``;
        start (B,) int32 tokens cached before the window; lengths (B,)
        int32 start + live window rows (rows past it are padding and
        write to the scratch page); block_table (B, MB) int32 → logits
        (B, W, vocab).  Every layer writes the window's K/V into its
        pools first; row w equals the decode step at length start+1+w
        over the same pool bytes."""
        st = self._check_pools(pools)

        def attend(i, qkv):
            return att.qkv_paged_verify_attend(
                qkv, pools[st * i:st * (i + 1)], block_table, start,
                lengths, self.num_heads)

        return self._trunk(data, positions, attend, adapter)

    @torch.no_grad()
    def forward(self, data: torch.Tensor) -> torch.Tensor:
        """Full causal forward: data (B, T) → logits (B, T, vocab)."""
        B, T = data.shape
        positions = torch.arange(T, device=data.device)[None].expand(B, T)
        return self._trunk(
            data, positions,
            lambda i, qkv: att.qkv_self_attention(
                qkv, self.num_heads, causal=True,
                block_size=self.kv_block))
