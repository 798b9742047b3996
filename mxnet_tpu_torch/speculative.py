"""Speculative decoding: the n-gram draft proposer and the exact verify
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
* :func:`verify_sample`: greedy rows emit argmax; a temperature row
  with a draft ``d`` accepts it with probability ``p_target(d)``, else
  samples the residual (``d`` removed, renormalized); a row with no
  draft samples exactly as ``serving.sample_tokens`` does, bit for bit.

The draft-LM proposer needs a trained draft checkpoint and is not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, not_ported
from .random import gumbel_noise, stream_key, sub_key, uniform

__all__ = ["NgramProposer", "make_proposer", "verify_sample", "PROPOSERS"]

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


def make_proposer(name: str, **kw):
    """Proposer registry (``MXNET_SERVING_PROPOSER``): unknown names
    raise at engine construction."""
    if name == "ngram":
        return NgramProposer(**kw)
    if name == "draft_lm":
        raise not_ported("the draft-LM proposer (proposer='draft_lm' / "
                         "MXNET_SERVING_PROPOSER=draft_lm)")
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
        u = uniform([sub_key(keys[i], 1) for i in sel], dev)
        residual = rows_s.scatter(1, d_d[:, None], -float("inf"))
        redraw = torch.argmax(
            residual + gumbel_noise([sub_key(keys[i], 2) for i in sel], V,
                                    dev), dim=-1)
        toks[s_d] = torch.where(u < p, d_d, redraw)
    out[b_d, j_d] = toks
    return out.to(torch.int32)
