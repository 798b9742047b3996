"""Decoder-only transformer LM: the serving forms of ``transformer_lm``.

Counterpart of ``mxnet_tpu/models/transformer.py`` (``_decode_block``,
``_lm_trunk``, ``transformer_lm_prefill``/``_decode``).  The JAX
package builds these as symbol graphs; here they are fixed chains of
the port's ops on one ``nn.Module``:

* ``prefill`` — the causal forward over a (padded) prompt that also
  writes every layer's K/V into the paged pools;
* ``decode`` — one token per stream against the paged pools;
* ``forward`` — the full causal forward over whole sequences, what
  prefill plus decode steps are checked against.

Parameter names are the training symbol's argument names
(``tok_embed_weight``, ``layer{i}_qkv_weight``, ..., ``head_bias``), so
one checkpoint dict binds to both packages.  Pre-LN residual blocks,
learned positions, exact-erf GELU.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
from torch import nn

from ..base import MXNetError
from ..ops import attention as att
from ..ops.indexing import embedding, take
from ..ops.nn import fully_connected, gelu, layer_norm

__all__ = ["TransformerLM", "param_names"]

_LAYER_PARAMS = ("ln1_gamma", "ln1_beta", "qkv_weight", "qkv_bias",
                 "proj_weight", "proj_bias", "ln2_gamma", "ln2_beta",
                 "ff1_weight", "ff1_bias", "ff2_weight", "ff2_bias")


def param_names(num_layers: int) -> List[str]:
    """Parameter names of a ``num_layers`` LM, in symbol order."""
    names = ["tok_embed_weight", "pos_embed_weight"]
    for i in range(num_layers):
        names += [f"layer{i}_{p}" for p in _LAYER_PARAMS]
    return names + ["ln_f_gamma", "ln_f_beta", "head_weight", "head_bias"]


class TransformerLM(nn.Module):
    """The LM over a dict of parameter tensors (see ``params_from_numpy``).

    ``kv_block`` is the cache page size and the plain attention's block
    size (the JAX graphs' ``block_size=kv_block``).  Pools are passed as
    a flat list ``[k_0, v_0, k_1, v_1, ...]`` of (P, KVB, H, D) tensors
    and are written in place."""

    def __init__(self, params: Dict[str, torch.Tensor], *, num_layers: int,
                 num_heads: int, kv_block: int = 16):
        super().__init__()
        names = param_names(num_layers)
        missing = [n for n in names if n not in params]
        if missing:
            raise MXNetError(f"params missing {missing} for a "
                             f"{num_layers}-layer transformer_lm")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.kv_block = int(kv_block)
        d_model = params["tok_embed_weight"].shape[1]
        if d_model % self.num_heads:
            raise MXNetError(f"d_model {d_model} % num_heads "
                             f"{self.num_heads} != 0")
        for n in names:
            self.register_parameter(
                n, nn.Parameter(params[n], requires_grad=False))

    def _p(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def _trunk(self, data, positions,
               attend: Callable[[int, torch.Tensor], torch.Tensor]):
        """Embedding → blocks → ln_f → head logits; layer i's attention
        sublayer is ``attend(i, qkv) -> (B, S, H*D)``."""
        x = embedding(data, self._p("tok_embed_weight")) \
            + take(self._p("pos_embed_weight"), positions)
        for i in range(self.num_layers):
            p = f"layer{i}_"
            h = layer_norm(x, self._p(p + "ln1_gamma"),
                           self._p(p + "ln1_beta"))
            qkv = fully_connected(h, self._p(p + "qkv_weight"),
                                  self._p(p + "qkv_bias"))
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
                               self._p("head_bias"))

    def _check_pools(self, pools: Sequence[torch.Tensor]) -> None:
        if len(pools) != 2 * self.num_layers:
            raise MXNetError(f"expected {2 * self.num_layers} pools "
                             f"[k_0, v_0, ...]; got {len(pools)}")

    @torch.no_grad()
    def prefill(self, data, positions, lengths, block_table,
                pools: Sequence[torch.Tensor]) -> torch.Tensor:
        """data/positions (B, T) int, lengths (B,) int32 prompt lengths,
        block_table (B, MB) int32 → logits (B, T, vocab); every layer's
        K/V of rows < lengths lands in its pools (padding rows on the
        scratch page)."""
        self._check_pools(pools)

        def attend(i, qkv):
            out, k, v = att.qkv_self_attention_prefill(
                qkv, self.num_heads, block_size=self.kv_block)
            att.paged_prefill_write(k, v, pools[2 * i], pools[2 * i + 1],
                                    block_table, lengths)
            return out

        return self._trunk(data, positions, attend)

    @torch.no_grad()
    def decode(self, data, positions, lengths, block_table,
               pools: Sequence[torch.Tensor]) -> torch.Tensor:
        """One token per stream: data/positions (B, 1), lengths (B,)
        int32 counting the current token (0 = padded slot), block_table
        (B, MB) int32 → logits (B, 1, vocab); the token's K/V is written
        into the pools first."""
        self._check_pools(pools)

        def attend(i, qkv):
            out, _, _ = att.qkv_paged_attention_decode(
                qkv, pools[2 * i], pools[2 * i + 1], block_table, lengths,
                self.num_heads)
            return out

        return self._trunk(data, positions, attend)

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
