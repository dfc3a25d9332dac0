"""Context-parallel prefill: one long prompt sharded over a ring.

The counterpart of ``hadoop_tpu/serving/longctx/prefill.py``. The
prompt is padded to one pinned length, sequence-sharded over the ``sp``
ranks of a ring (``plan.cp_mesh``), and every rank runs the full layer
stack on its shard with ring attention (``parallel/ring_attention.py``)
or Ulysses (``parallel/ulysses.py``: the heads exchanged for the
sequence, one causal kernel launch a layer); the per-layer post-RoPE
K/V of every position comes back as data
(``models.decoder.run_layers_kv``), taken before any exchange, so both
strategies stream the same layout. Causal
masking keeps the padded tail invisible to real positions, and padded
K/V is never streamed.

The ranks share one device in this port (``plan.Ring``): the kernel work
per rank is an sp-device deployment's, the wall time is one device's.
The reference jits the job at its pinned shape; the port runs eagerly,
so ``prefill_compiles`` and ``head_compiles`` count the distinct shapes
the layer stack and the head ran at (1 each when the pinned shape
holds), the meaning the engine's step counters have in this port.

An int8 weight-plane tree (``serving/weightplane.py``, the engine's own
plane, shared) runs every local matmul through ``qdot`` (the ctx's
``relaxed_qweights``) and the head through ``qhead``. A MoE config
routes each rank's tokens on their own (``models/decoder.py``), at the
capacity of that rank's count, as each rank of the reference's
``shard_map`` does. Left out: the comm-ledger and tracer hooks (as the
engine left them out).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from hadoop_tpu_torch.device import check_on
from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.models.decoder import (ParallelCtx, embed_tokens,
                                             final_hidden, head_matrix,
                                             run_layers_kv)
from hadoop_tpu_torch.ops import rope_frequencies
from hadoop_tpu_torch.serving.longctx.plan import choose_sp_mode, cp_mesh
from hadoop_tpu_torch.serving.weightplane import (is_qtensor,
                                                  is_quantized_tree, qhead)

log = logging.getLogger(__name__)


@dataclass
class PrefillResult:
    """What a CP prefill hands downstream: the last real token's logits,
    the full-block K/V payloads as a stream of host tensors (the caller
    forwards them to a store without holding the whole context), and
    the partial tail block's K/V."""
    last_logits: np.ndarray                 # [V] float32
    n_full_blocks: int
    blocks: Iterator[Tuple[torch.Tensor, torch.Tensor]] = field(repr=False)
    tail_k: Optional[torch.Tensor] = None   # [L, S % bs, Hkv, Dh]
    tail_v: Optional[torch.Tensor] = None
    seconds: float = 0.0
    chips: int = 1
    sp_mode: str = "ring"
    prompt_tokens: int = 0


class ContextParallelPrefiller:
    """One replica's CP prefill: a ring at one pinned shape, reused for
    every long prompt. ``devices``: None for the current GPU, or devices
    that all name the one device the parameters lie on (e.g. ``["cpu"]``).
    """

    def __init__(self, params, cfg: ModelConfig, *, block_size: int,
                 pad_tokens: int, sp: int = 0, sp_mode: str = "ring",
                 devices=None):
        self.sp = int(sp) if sp else (len(devices) if devices else 1)
        self.cfg = cfg
        self.params = params
        self.block_size = int(block_size)
        self.sp_mode = choose_sp_mode(cfg, self.sp, sp_mode)
        quantum = self.sp * self.block_size
        if int(pad_tokens) > cfg.max_seq:
            raise ValueError(
                f"serving.longctx.max.tokens={pad_tokens} exceeds the "
                f"model's max_seq {cfg.max_seq} — positions past the "
                f"rope/pos tables would silently clamp")
        self.pad_tokens = -(-int(pad_tokens) // quantum) * quantum
        if self.pad_tokens > cfg.max_seq:
            # rounding UP to the quantum overshoots max_seq (max_seq not
            # divisible by sp*block): round DOWN; prompts in the shaved
            # tail are rejected per request
            self.pad_tokens = (cfg.max_seq // quantum) * quantum
            if self.pad_tokens < self.block_size:
                raise ValueError(
                    f"max_seq {cfg.max_seq} below one sp*block "
                    f"quantum ({quantum}) — too many ranks for this "
                    f"model's sequence budget")
            log.warning(
                "longctx pad budget rounded DOWN to %d (max_seq %d is "
                "not divisible by sp*block %d); prompts above it are "
                "rejected per-request", self.pad_tokens, cfg.max_seq,
                quantum)
        self.ring = cp_mesh(self.sp, devices)
        embed = params["embed"]
        check_on(embed["q"] if is_qtensor(embed) else embed,
                 self.ring.device, "params")
        # the relaxed tier's opt-in: a quantized tree's matmuls dequantize
        self.ctx = ParallelCtx(ring="sp", ring_size=self.sp,
                               sp_mode=self.sp_mode,
                               relaxed_qweights=is_quantized_tree(params))
        self._cos, self._sin = rope_frequencies(
            cfg.head_dim, cfg.max_seq, cfg.rope_theta,
            device=self.ring.device)
        self._shapes = {"layers": set(), "head": set()}

    @property
    def prefill_compiles(self) -> int:
        """Distinct shapes the layer stack ran at (1 when pinned)."""
        return len(self._shapes["layers"])

    @property
    def head_compiles(self) -> int:
        """Distinct shapes the head ran at (1 when pinned)."""
        return len(self._shapes["head"])

    # -------------------------------------------------------- the job

    @torch.no_grad()
    def _run(self, tokens: torch.Tensor):
        """tokens [sp, S_local], rank r's shard on row r → (h [sp,
        S_local, D] after the final norm, k, v [L, sp, S_local, Hkv,
        Dh])."""
        self._shapes["layers"].add(tuple(tokens.shape))
        h = embed_tokens(self.params, tokens, self.cfg, self.ctx)
        h, (ks, vs) = run_layers_kv(h, self.params["layers"], self.cfg,
                                    self._cos, self._sin, self.ctx)
        return final_hidden(self.params, h, self.cfg), ks, vs

    @torch.no_grad()
    def _head(self, row: torch.Tensor) -> torch.Tensor:
        self._shapes["head"].add(tuple(row.shape))
        cfg = self.cfg
        head = self.params["embed"] if cfg.tie_embeddings \
            else self.params.get("lm_head")
        if is_qtensor(head):
            return qhead(self.params, row, cfg).float()
        return (row @ head_matrix(self.params, cfg, row.dtype)).float()

    def cp_prefill(self, tokens: List[int]) -> PrefillResult:
        """Prefill ``tokens`` across the ring."""
        s = len(tokens)
        if s < 2:
            raise ValueError("longctx prefill needs at least 2 tokens")
        if s > self.pad_tokens:
            raise ValueError(
                f"prompt ({s} tokens) exceeds the pinned longctx "
                f"budget {self.pad_tokens} (serving.longctx.max.tokens)")
        padded = torch.zeros(self.pad_tokens, dtype=torch.long)
        padded[:s] = torch.as_tensor(tokens, dtype=torch.long)
        t0 = time.monotonic()
        h, ks, vs = self._run(padded.to(self.ring.device).view(self.sp, -1))
        logits = self._head(h.reshape(-1, h.shape[-1])[s - 1]).cpu().numpy()
        seconds = time.monotonic() - t0
        bs = self.block_size
        n_full = s // bs
        tail_k = tail_v = None
        if s > n_full * bs:
            tail_k, tail_v = self._slice_seq(ks, vs, n_full * bs, s)
        return PrefillResult(
            last_logits=logits, n_full_blocks=n_full,
            blocks=self._iter_blocks(ks, vs, n_full),
            tail_k=tail_k, tail_v=tail_v, seconds=seconds,
            chips=self.sp, sp_mode=self.sp_mode, prompt_tokens=s)

    # -------------------------------------------- shard-order streaming

    def _iter_blocks(self, ks, vs, n_full: int
                     ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Yield full-block [L, bs, Hkv, Dh] (K, V) host tensors in chain
        order, copying ONE rank's shard to the host at a time: the full
        context never lies on the host as one tensor."""
        bs = self.block_size
        limit = n_full * bs
        local = ks.shape[2]
        for rank in range(self.sp):
            start = rank * local
            if start >= limit:
                return
            k_host, v_host = ks[:, rank].cpu(), vs[:, rank].cpu()
            for off in range(0, local, bs):
                if start + off + bs > limit:
                    return
                yield k_host[:, off:off + bs], v_host[:, off:off + bs]

    def _slice_seq(self, ks, vs, lo: int, hi: int):
        """Host copy of sequence positions [lo, hi), the partial tail
        block (it never crosses a shard: shard boundaries are multiples
        of block_size and hi - lo < block_size)."""
        local = ks.shape[2]
        rank = lo // local
        off = lo - rank * local
        return (ks[:, rank, off:off + hi - lo].cpu(),
                vs[:, rank, off:off + hi - lo].cpu())
