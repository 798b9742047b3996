"""Speculative decoding: the draft proposers and the exact verify
sampler.

Counterpart of ``mxnet_tpu/speculative.py``.  A cheap **proposer**
guesses ``k`` tokens, the target model scores the pending token and all
``k`` drafts in ONE multi-query step (``TransformerLM.verify``), and the
longest verified prefix plus one token the target emits at the first
mismatch commits (Leviathan et al., "Fast Inference from Transformers
via Speculative Decoding").  Every emitted token is an exact sample of
the target model, so greedy output equals non-speculative decoding and
temperature output keeps the target distribution.

* :class:`NgramProposer` (prompt-lookup decoding): continue the most
  recent earlier occurrence of the stream's trailing n-gram.  Pure
  numpy, carried over as it is; deterministic in the context.
* :class:`DraftLMProposer`: a small ``transformer_lm`` drafts greedily
  for the big one, one full causal forward a proposed token
  (``TransformerLM.forward``, the ``flash_mha_packed`` kernel on the
  card), deterministic in the context.
* :func:`verify_sample`: greedy rows emit argmax; a temperature row
  with a draft ``d`` accepts it with probability ``p_target(d)``, else
  samples the residual (``d`` removed, renormalized); a row with no
  draft samples exactly as ``serving.sample_tokens`` does, bit for bit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .base import MXNetError, get_env
from .random import gumbel_noise, stream_key, sub_key, uniform_per_key

__all__ = ["NgramProposer", "DraftLMProposer", "make_proposer",
           "draft_lm_from_env", "verify_sample", "PROPOSERS"]

PROPOSERS = ("ngram", "draft_lm")


class NgramProposer:
    """Prompt-lookup self-drafting: propose the continuation of the
    most recent earlier occurrence of the stream's trailing n-gram.

    Tries the longest n-gram first (``max_ngram`` down to
    ``min_ngram``); the first (longest) match wins, and within one
    n-gram length the MOST RECENT occurrence wins — both choices are
    deterministic functions of the context, never of wall time or
    iteration order."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not (1 <= min_ngram <= max_ngram):
            raise MXNetError(
                f"NgramProposer wants 1 <= min_ngram <= max_ngram; got "
                f"min={min_ngram} max={max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        """Up to ``k`` draft tokens continuing ``context`` (1-D int32,
        prompt + everything generated so far, pending token included).
        Empty when no trailing n-gram recurs earlier in the context.

        The scan is vectorized (one sliding-window comparison per
        n-gram length): the proposer runs on the scheduler thread once
        per stream per step."""
        ctx = np.asarray(context, np.int32)
        n = ctx.size
        if k < 1 or n < self.min_ngram + 1:
            return np.empty(0, np.int32)
        for g in range(min(self.max_ngram, n - 1), self.min_ngram - 1,
                       -1):
            tail = ctx[n - g:]
            # windows[i] = ctx[i:i+g] for i in [0, n-g-1]: every
            # earlier g-gram (the final window — the tail itself — is
            # excluded so the match has a continuation to copy)
            windows = np.lib.stride_tricks.sliding_window_view(
                ctx[:-1], g)
            hits = np.flatnonzero((windows == tail).all(axis=1))
            if hits.size:
                end = int(hits[-1]) + g  # most recent occurrence
                take = min(k, n - end)
                if take > 0:
                    return ctx[end:end + take].copy()
        return np.empty(0, np.int32)


class DraftLMProposer:
    """A small LM drafting for the big one (Leviathan et al.'s two-model
    speculation) behind ``propose(context, k)``
    (``mxnet_tpu/speculative.py:108-199``).

    Drafting is greedy, so the drafts are a deterministic function of
    the context; the verify sampler keeps the target's distribution
    exact whatever the drafts.  The draft sees at most its own window:
    the context's tail, room left for ``k`` drafts (``k`` at most
    ``max_len - 1``), at positions from 0.  Each proposed token is one
    causal forward of ``TransformerLM.forward`` over the ``t`` tokens so
    far on the draft's device, read at row ``t - 1`` (the JAX draft pads
    to ``max_len`` for one fixed-shape executable, which causality makes
    invisible; here the forward runs the real tokens only).  No second
    KV cache.  The architecture is read from the parameter names and
    shapes; ``num_heads`` is not (a fused QKV weight does not record
    it) and must be given.  ``ctx`` is the draft's device (default
    ``gpu(0)``: the engine's).  ``forwards`` counts the forwards run."""

    def __init__(self, params: Dict, *, num_heads: int, kv_block: int = 16,
                 ctx=None):
        from .context import current_context
        from .convert import params_from_numpy
        from .models.transformer import TransformerLM, param_names

        for need in ("tok_embed_weight", "pos_embed_weight",
                     "layer0_qkv_weight", "layer0_ff1_weight"):
            if need not in params:
                raise MXNetError(
                    f"draft_lm checkpoint is missing {need!r} — "
                    f"MXNET_SERVING_DRAFT_CKPT must point at a "
                    f"transformer_lm checkpoint (have: "
                    f"{sorted(params)[:8]}...)")
        self.vocab_size, d_model = (int(n) for n in
                                    params["tok_embed_weight"].shape)
        self.max_len = int(params["pos_embed_weight"].shape[0])
        self.d_model = d_model
        self.num_layers = max(
            int(k[len("layer"):-len("_qkv_weight")]) for k in params
            if k.startswith("layer") and k.endswith("_qkv_weight")) + 1
        self.num_heads = int(num_heads)
        if self.num_heads < 1 or self.d_model % self.num_heads:
            raise MXNetError(
                f"MXNET_SERVING_DRAFT_HEADS={num_heads} must be >= 1 "
                f"and divide the draft d_model {self.d_model}")
        missing = [n for n in param_names(self.num_layers)
                   if n not in params]
        if missing:
            raise MXNetError(
                f"draft_lm checkpoint is missing parameters {missing}")
        self.device = (ctx if ctx is not None
                       else current_context()).torch_device()
        self.model = TransformerLM(
            params_from_numpy({n: params[n]
                               for n in param_names(self.num_layers)},
                              self.device, dtype=None),
            num_layers=self.num_layers, num_heads=self.num_heads,
            kv_block=kv_block)
        self.forwards = 0

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        ctx = np.asarray(context, np.int32)
        if k < 1 or ctx.size == 0:
            return np.empty(0, np.int32)
        k = min(int(k), self.max_len - 1)
        # the draft's window: the context's tail (the recent tokens carry
        # the signal), leaving room for the k drafts
        keep = max(1, self.max_len - k)
        seq = torch.as_tensor(ctx[-keep:], device=self.device)
        out = []
        for _ in range(k):
            logits = self.model(seq[None])
            self.forwards += 1
            nxt = torch.argmax(logits[0, -1]).to(torch.int32)
            out.append(int(nxt))  # one device-to-host copy a draft
            seq = torch.cat([seq, nxt[None]])
        return np.asarray(out, np.int32)


def draft_lm_from_env(kv_block: int = 16, ctx=None) -> DraftLMProposer:
    """The draft-LM proposer of ``MXNET_SERVING_DRAFT_CKPT`` (its newest
    committed checkpoint, of either package) and
    ``MXNET_SERVING_DRAFT_HEADS``, validated at engine construction."""
    from .checkpoint import load_latest_params

    path = get_env("MXNET_SERVING_DRAFT_CKPT", None, str)
    if not path:
        raise MXNetError(
            "MXNET_SERVING_PROPOSER=draft_lm needs "
            "MXNET_SERVING_DRAFT_CKPT pointing at the draft model's "
            "checkpoint directory")
    raw = get_env("MXNET_SERVING_DRAFT_HEADS", None, str)
    try:
        heads = int(raw) if raw is not None else 0
    except ValueError:
        raise MXNetError(
            f"MXNET_SERVING_DRAFT_HEADS={raw!r} is not an integer")
    if heads < 1:
        raise MXNetError(
            f"MXNET_SERVING_DRAFT_HEADS={heads} must be >= 1 when "
            f"MXNET_SERVING_PROPOSER=draft_lm")
    params, _, _ = load_latest_params(path)
    return DraftLMProposer(params, num_heads=heads, kv_block=kv_block,
                           ctx=ctx)


def make_proposer(name: str, **kw):
    """Proposer registry (``MXNET_SERVING_PROPOSER``): unknown names
    raise at engine construction.  ``draft_lm`` builds from ``params``
    when given, else from the environment (``draft_lm_from_env``)."""
    if name == "ngram":
        return NgramProposer(**kw)
    if name == "draft_lm":
        if "params" in kw:
            return DraftLMProposer(**kw)
        return draft_lm_from_env(**kw)
    raise MXNetError(
        f"unknown speculative proposer {name!r} "
        f"(MXNET_SERVING_PROPOSER wants one of {PROPOSERS})")


def verify_sample(logits: torch.Tensor, fed: np.ndarray, wlive: np.ndarray,
                  temps: np.ndarray, seeds: np.ndarray, steps0: np.ndarray,
                  engine_seed: int) -> torch.Tensor:
    """One emission per verify-window row, on the logits' device.

    ``logits`` (B, W, V): row ``j`` of stream ``b`` sits at position
    ``steps0[b] + j`` and predicts the next slot.  ``fed`` (B, W) the
    tokens fed (``[pending, draft_1, ...]``; pad columns may hold
    anything); ``wlive`` (B,) live rows per stream (1 + drafts): the
    draft checked at row ``j`` is ``fed[b, j+1]`` only while ``j + 1 <
    wlive[b]``; the last live row and the pad rows have none (a pad
    column is never taken for a draft of token 0).  ``temps``,
    ``seeds``, ``steps0`` (B,): the plain step's sampling identity, row
    ``j`` keyed by ``stream_key(engine_seed, seeds[b], steps0[b] + j)``.

    Greedy rows (temp <= 0) emit argmax.  A temperature row with draft
    ``d`` accepts it when a uniform (``sub_key(key, 1)``) is below
    ``softmax(logits / temp)[d]``, else emits a Gumbel-max draw of the
    residual (``d`` masked out, ``sub_key(key, 2)``).  A row with no
    draft emits ``argmax(logits / temp + gumbel_noise(key))``, exactly
    ``serving.sample_tokens``'s draw.  Returns (B, W) int32; the caller
    keeps emissions while each matches the next fed token, plus the
    first that does not."""
    B, W, V = logits.shape
    dev = logits.device
    out = torch.argmax(logits, dim=-1)
    fed = np.asarray(fed)
    drafts = np.full((B, W), -1, np.int64)
    drafts[:, :-1] = fed[:, 1:]
    drafts[np.arange(W)[None, :] + 1 >= np.asarray(wlive)[:, None]] = -1
    rows = np.nonzero(np.asarray(temps) > 0)[0]
    if not rows.size:
        return out.to(torch.int32)
    bi = np.repeat(rows, W)
    ji = np.tile(np.arange(W), rows.size)
    keys = [stream_key(engine_seed, seeds[b], steps0[b] + j)
            for b, j in zip(bi, ji)]
    b_d = torch.as_tensor(bi, device=dev)
    j_d = torch.as_tensor(ji, device=dev)
    t = torch.as_tensor(np.asarray(temps)[bi], dtype=torch.float32,
                        device=dev)
    scaled = logits[b_d, j_d].float() / t[:, None]
    toks = torch.argmax(scaled + gumbel_noise(keys, V, dev), dim=-1)
    d = drafts[bi, ji]
    sel = np.nonzero(d >= 0)[0]
    if sel.size:
        s_d = torch.as_tensor(sel, device=dev)
        d_d = torch.as_tensor(np.clip(d[sel], 0, V - 1), device=dev)
        rows_s = scaled[s_d]
        p = torch.softmax(rows_s, dim=-1).gather(1, d_d[:, None])[:, 0]
        u = uniform_per_key([sub_key(keys[i], 1) for i in sel], dev)
        residual = rows_s.scatter(1, d_d[:, None], -float("inf"))
        redraw = torch.argmax(
            residual + gumbel_noise([sub_key(keys[i], 2) for i in sel], V,
                                    dev), dim=-1)
        toks[s_d] = torch.where(u < p, d_d, redraw)
    out[b_d, j_d] = toks
    return out.to(torch.int32)
