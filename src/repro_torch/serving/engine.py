"""Per-worker continuous-batching engine with a paged KV cache (vLLM-style),
ported from the reference ``repro.serving.engine``.

Slot-based execution over a page pool: each running request owns a slot and
a list of pages (block table); page 0 is the null page that unused
block-table entries point at. Iteration-level scheduling (Orca-style): new
requests run a prefill iteration (preempting decode, as vLLM does — the
paper's constraint (d) budgets exactly this), otherwise all running slots
advance one decode step via paged attention.

Precision follows the reference: prefill runs in the parameter dtype (bf16
for the paper's models), decode and the chunked prefill in fp32 — the
reference's jnp promotion of bf16 weights against fp32 activations is an
fp32 copy of the weights those two read here (``decode_weights``), made
when an engine is built; a ``ServingCluster`` makes it once and hands it to
every worker. The KV pool is fp32.

On a CUDA device every prefill and decode iteration goes through the port's
kernels (B1 paged decode, B2 flash attention, B3 RMSNorm); on the CPU
through their plain versions. CUDA launches are asynchronous, so every
clock read that feeds the TraceBuffer follows a host read of the
iteration's result (``.item()`` / ``.cpu()``), which waits for the device:
iteration wall-times, not launch latencies, fit the paper's Eqs. 1-3. The
clock is read at the same places and as often as in the reference.

The decode step is one function of static shapes (``_decode_step``): every
slot is computed and the active slots' KV written under a mask, from
persistent input tensors that each step fills from the host's state. On
CUDA an engine captures it in one CUDA graph when it is built and replays
that graph each decode step, so the host enqueues one launch where it
enqueued the step's ~60 kernels a layer; on the CPU it runs eagerly.

Each step is a span of ``serving/spans.py``'s ``RECORDER``, as are its
prefills and a decode step's host launch and device wait; the recorder
reads its own clock, apart from ``time_fn``."""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, Family, PosEmb
from repro_torch.core.perf_model import TraceBuffer
from repro_torch.core.request import ReqState, Request
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models.common import gated_mlp, rms_norm, rope, \
    sinusoidal_pos
from repro_torch.models.model import LM
from repro_torch.serving.spans import RECORDER

# the kernels a decode step launches: a CUDA graph counts their launches
# once, at capture, so each replay adds the capture's counts to theirs
_DECODE_KERNELS = (paged_decode_attention, rmsnorm)
_WARMUP_STEPS = 3         # eager steps on a side stream before the capture


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    page_size: int = 16
    n_pages: int = 512
    max_pages_per_seq: int = 64
    max_new_tokens: int = 2048
    prefill_chunk: int = 0          # >0: Sarathi-style chunked prefill — at
                                    # most this many prompt tokens per
                                    # iteration, bounding decode preemption
                                    # stalls (shrinks constraint (d) pressure)


def decode_weights(params, head: torch.Tensor) -> dict:
    """The weights that decode and the chunked prefill read (every ``seg0``
    leaf, stacked (L, ...), and ``head`` (D, V)) in fp32: for bf16 params a
    copy, for fp32 params the params' own tensors. The copy is of the
    weights as they are now; whoever changes ``params`` later makes it
    anew."""
    return {"seg0": {k: t.float() for k, t in params["seg0"].items()},
            "head": head.float()}


class PagedEngine:
    """One worker's execution engine."""

    decode_captures = 0     # CUDA graphs of the decode step captured
    decode_replays = 0      # decode steps run by replaying one

    def __init__(self, arch: ArchConfig, params, cfg: EngineConfig,
                 time_fn: Callable[[], float] = time.perf_counter,
                 device: DeviceLike = None,
                 w32: Optional[dict] = None):
        """``w32``: ``decode_weights`` of these ``params``, to share one
        fp32 copy between engines (``ServingCluster`` does); None makes this
        engine its own."""
        if arch.family not in (Family.DENSE, Family.AUDIO):
            raise ValueError("engine path supports dense GQA archs (the "
                             "paper's models)")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.arch = arch
        self.params = params
        self.cfg = cfg
        self.time_fn = time_fn
        self.traces = TraceBuffer()
        self.model = LM(arch, device=self.device)
        self.w32 = w32 if w32 is not None else decode_weights(
            params, self.model.head_weight(params))
        L = arch.n_layers
        hd = arch.resolved_head_dim
        self.kv_k = torch.zeros((L, cfg.n_pages, cfg.page_size,
                                 arch.n_kv_heads, hd), dtype=torch.float32,
                                device=self.device)
        self.kv_v = torch.zeros_like(self.kv_k)
        self.block_tables = np.zeros((cfg.max_batch, cfg.max_pages_per_seq),
                                     np.int32)
        self.lengths = np.zeros((cfg.max_batch,), np.int32)
        self.free_pages = list(range(cfg.n_pages - 1, 0, -1))  # page 0 = null
        self.slots: List[Optional[Request]] = [None] * cfg.max_batch
        self.waiting: List[Request] = []
        self.kv_bytes_per_token = 2 * L * arch.n_kv_heads * hd * 4
        self._decode_inputs()
        self._graph = None
        if self.device.type == "cuda":
            self._capture()

    # ---- admission / state --------------------------------------------------
    def can_admit(self, n_tokens_total: int) -> bool:
        pages_needed = n_tokens_total // self.cfg.page_size + 2
        return (any(s is None for s in self.slots)
                and len(self.free_pages) >= pages_needed)

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    @property
    def running(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def kv_used_bytes(self) -> float:
        return float(self.lengths.sum()) * self.kv_bytes_per_token / 2

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # ---- model math ---------------------------------------------------------
    def _decode_inputs(self) -> None:
        """The decode step's inputs (``_inputs``): ``tokens`` (B,) int64,
        ``block_tables`` (B, max_pages) int32, ``lengths`` (B,) int32 and
        ``active`` (B,) bool, B = max_batch, and the host tensors a step
        fills them from (``_staged``). On CUDA the inputs are on the card,
        where the graph reads them, the staging is pinned and ``_loaded``
        marks the end of a step's copies; on the CPU the two are one."""
        b = self.cfg.max_batch
        cuda = self.device.type == "cuda"
        self._staged = {
            name: torch.zeros(shape, dtype=dtype, pin_memory=cuda)
            for name, shape, dtype in (
                ("tokens", (b,), torch.int64),
                ("block_tables", (b, self.cfg.max_pages_per_seq),
                 torch.int32),
                ("lengths", (b,), torch.int32),
                ("active", (b,), torch.bool))}
        self._inputs = {k: t.to(self.device) for k, t in self._staged.items()}
        self._loaded = torch.cuda.Event() if cuda else None

    def _load_inputs(self, tokens: np.ndarray,
                     active_slots: List[int]) -> None:
        """Fill the decode step's inputs from the host's state: on CUDA
        into the pinned staging, then one asynchronous copy an input."""
        if self._loaded is not None:
            self._loaded.synchronize()   # the last step's copies are done
        st = self._staged
        st["tokens"].numpy()[:] = tokens
        st["block_tables"].numpy()[:] = self.block_tables
        st["lengths"].numpy()[:] = self.lengths
        active = st["active"].numpy()
        active[:] = False
        active[active_slots] = True
        if self._loaded is not None:
            for k, t in self._inputs.items():
                t.copy_(st[k], non_blocking=True)
            self._loaded.record()

    def _decode_step(self, tokens, block_tables, lengths, active):
        """One decode iteration for every slot, on the step's input tensors
        (``_decode_inputs``). The KV of the active slots is written in
        place; an inactive slot's write puts back what it reads (its
        block-table row is the null page), as the reference's masked write
        does. Reads nothing from the host, so a CUDA graph can hold it.
        Returns logits (max_batch, V) in fp32."""
        a = self.arch
        hd = a.resolved_head_dim
        seg = self.w32["seg0"]
        x = self.params["embed"][tokens].float()
        if a.tie_embeddings:
            x = x * math.sqrt(a.d_model)
        if a.pos_emb == PosEmb.SINUSOIDAL:
            x = x + sinusoidal_pos(lengths, a.d_model)
        pos = lengths.long()
        page_ids = block_tables.gather(
            1, (pos // self.cfg.page_size)[:, None])[:, 0].long()
        offs = pos % self.cfg.page_size
        msk = active[:, None, None]
        seq_lens = lengths + 1
        rope_pos = lengths[:, None].float()     # once, not once a layer
        for i in range(a.n_layers):
            p = {k: t[i] for k, t in seg.items()}
            h = rms_norm(x, p["ln1"], a.norm_eps)
            q = (h @ p["wq"]).reshape(-1, a.n_heads, hd)
            k = (h @ p["wk"]).reshape(-1, a.n_kv_heads, hd)
            v = (h @ p["wv"]).reshape(-1, a.n_kv_heads, hd)
            if a.qkv_bias:
                q = q + p["bq"].reshape(a.n_heads, hd)
                k = k + p["bk"].reshape(a.n_kv_heads, hd)
                v = v + p["bv"].reshape(a.n_kv_heads, hd)
            if a.pos_emb == PosEmb.ROPE:
                q = rope(q[:, None], rope_pos, a.rope_theta)[:, 0]
                k = rope(k[:, None], rope_pos, a.rope_theta)[:, 0]
            kv_k, kv_v = self.kv_k[i], self.kv_v[i]
            kv_k[page_ids, offs] = torch.where(msk, k, kv_k[page_ids, offs])
            kv_v[page_ids, offs] = torch.where(msk, v, kv_v[page_ids, offs])
            att = paged_decode_attention(q.contiguous(), kv_k, kv_v,
                                         block_tables, seq_lens)
            x = x + att.reshape(x.shape[0], -1) @ p["wo"]
            h = rms_norm(x, p["ln2"], a.norm_eps)
            x = x + gated_mlp(h, p["wg"], p["wu"], p["wd"], a.act)
        x = rms_norm(x, self.params["final_ln"], a.norm_eps)
        return x @ self.w32["head"]

    def _capture(self) -> None:
        """Capture ``_decode_step`` on this engine's inputs in a CUDA graph
        (one an engine: the graph writes this engine's pools, and reads the
        weights and ``w32`` in place). Every slot is inactive, so no KV
        changes. Warm-up steps on a side stream first make what a first
        call makes (cuBLAS's handles and workspaces, the kernel library's
        settings) outside the capture."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP_STEPS):
                self._decode_step(**self._inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = [kern.launches for kern in _DECODE_KERNELS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._logits = self._decode_step(**self._inputs)
        # the capture launched nothing; each replay launches what it counted
        self._graph_launches = []
        for kern, n0 in zip(_DECODE_KERNELS, before):
            self._graph_launches.append((kern, kern.launches - n0))
            kern.launches = n0
        self._graph = graph
        self.decode_captures += 1
        RECORDER.instant("engine.decode.capture")

    def _decode(self, tokens: np.ndarray, active_slots: List[int]):
        """One decode iteration for every slot; the KV of the active slots
        is written in place. Returns logits (max_batch, V) in fp32: on CUDA
        the graph's output buffer, which the next step overwrites."""
        self._load_inputs(tokens, active_slots)
        if self._graph is None:
            return self._decode_step(**self._inputs)
        self._graph.replay()
        for kern, n in self._graph_launches:
            kern.launches += n
        self.decode_replays += 1
        RECORDER.instant("engine.decode.replay")
        return self._logits

    def _chunk(self, chunk_toks: List[int], k_ctx, v_ctx, ctx_len: int,
               logit_pos: int):
        """One chunked-prefill step in fp32: chunk tokens attend to the
        context KV (q_offset = ctx_len) and causally within the chunk,
        through kernel B2 with its runtime q_offset and kv_len.
        Returns (logits at logit_pos, chunk ks, vs: (L, C, Hkv, hd))."""
        a = self.arch
        hd = a.resolved_head_dim
        seg = self.w32["seg0"]
        x = self.params["embed"][self._tensor(chunk_toks, torch.long)].float()
        x = x[None]                                           # (1, C, D)
        if a.tie_embeddings:
            x = x * math.sqrt(a.d_model)
        c = x.shape[1]
        positions = ctx_len + torch.arange(c, device=self.device)
        kv_len = torch.full((1,), ctx_len + c, dtype=torch.int32,
                            device=self.device)
        ks_out, vs_out = [], []
        for i in range(a.n_layers):
            p = {k: t[i] for k, t in seg.items()}
            h = rms_norm(x, p["ln1"], a.norm_eps)
            q = (h @ p["wq"]).reshape(1, c, a.n_heads, hd)
            k = (h @ p["wk"]).reshape(1, c, a.n_kv_heads, hd)
            v = (h @ p["wv"]).reshape(1, c, a.n_kv_heads, hd)
            if a.qkv_bias:
                q = q + p["bq"].reshape(a.n_heads, hd)
                k = k + p["bk"].reshape(a.n_kv_heads, hd)
                v = v + p["bv"].reshape(a.n_kv_heads, hd)
            if a.pos_emb == PosEmb.ROPE:
                q = rope(q, positions, a.rope_theta)
                k = rope(k, positions, a.rope_theta)
            ks_out.append(k[0])
            vs_out.append(v[0])
            k_all = torch.cat([k_ctx[i][None], k], dim=1)
            v_all = torch.cat([v_ctx[i][None], v], dim=1)
            att = flash_attention(q.contiguous(), k_all, v_all, causal=True,
                                  q_offset=ctx_len, kv_len=kv_len)
            x = x + att.reshape(1, c, -1) @ p["wo"]
            h = rms_norm(x, p["ln2"], a.norm_eps)
            x = x + gated_mlp(h, p["wg"], p["wu"], p["wd"], a.act)
        x = rms_norm(x, self.params["final_ln"], a.norm_eps)
        logits = x[0, logit_pos] @ self.w32["head"]
        return logits, torch.stack(ks_out), torch.stack(vs_out)

    # ---- page management ----------------------------------------------------
    def _alloc_slot(self, req: Request, n_tokens: int) -> int:
        slot = self.slots.index(None)
        pages = (n_tokens + self.cfg.page_size - 1) // self.cfg.page_size
        if len(self.free_pages) < pages:
            raise RuntimeError("page pool exhausted at admission")
        tbl = np.zeros((self.cfg.max_pages_per_seq,), np.int32)
        for j in range(pages):
            tbl[j] = self.free_pages.pop()
        self.block_tables[slot] = tbl
        self.lengths[slot] = 0
        self.slots[slot] = req
        return slot

    def _ensure_page(self, slot: int) -> bool:
        pos = int(self.lengths[slot])
        pi = pos // self.cfg.page_size
        if pi >= self.cfg.max_pages_per_seq:
            return False
        if self.block_tables[slot, pi] == 0:
            if not self.free_pages:
                return False
            self.block_tables[slot, pi] = self.free_pages.pop()
        return True

    def _free_slot(self, slot: int) -> None:
        for pid in self.block_tables[slot]:
            if pid > 0:
                self.free_pages.append(int(pid))
        self.block_tables[slot] = 0
        self.lengths[slot] = 0
        self.slots[slot] = None

    # ---- iteration-level scheduling -----------------------------------------
    @RECORDER.traced("engine.step")
    def step(self, now: Optional[float] = None) -> List[Request]:
        """Run ONE iteration (a prefill batch or a decode batch). Returns the
        requests that finished."""
        finished: List[Request] = []
        t0 = self.time_fn()
        if self.waiting and self.can_admit(self.waiting[0].l_in + 8):
            total_in, batch = 0, []
            while self.waiting and self.can_admit(self.waiting[0].l_in + 8):
                r = self.waiting.pop(0)
                batch.append(r)
                total_in += r.l_in
                sp = RECORDER.begin("engine.prefill", r.id)
                self._run_prefill(r)       # ends in a host read: synced
                RECORDER.end(sp)
            t1 = self.time_fn()
            self.traces.record_prefill(total_in, t1 - t0)
            for r in batch:
                r.t_first_token = now if now is not None else t1
                r.state = ReqState.DECODING
            return finished
        active_slots = [i for i, r in enumerate(self.slots) if r is not None]
        if not active_slots:
            return finished
        for i in list(active_slots):
            if not self._ensure_page(i):
                r = self.slots[i]          # out of pages: preempt youngest
                self._free_slot(i)
                r.l_out = 0
                r.state = ReqState.QUEUED
                self.waiting.insert(0, r)
                active_slots.remove(i)
        if not active_slots:
            return finished
        tokens = np.zeros((self.cfg.max_batch,), np.int64)
        for i in active_slots:
            tokens[i] = self.slots[i].tokens[-1]
        sp = RECORDER.begin("engine.decode.launch")
        logits = self._decode(tokens, active_slots)
        RECORDER.end(sp)
        sp = RECORDER.begin("engine.decode.wait")
        nxt = logits.argmax(dim=-1).cpu().numpy()   # waits for the device
        RECORDER.end(sp)
        t1 = self.time_fn()
        total_ctx = int(self.lengths[active_slots].sum()) + len(active_slots)
        self.traces.record_decode(len(active_slots), total_ctx, t1 - t0)
        for i in active_slots:
            r = self.slots[i]
            self.lengths[i] += 1
            r.l_out += 1
            r.t_decode_spent += (t1 - t0)
            r.tokens.append(int(nxt[i]))
            self.traces.record_kv(
                r.context, r.context * self.kv_bytes_per_token / 2)
            if r.l_out >= min(r.l_real or self.cfg.max_new_tokens,
                              self.cfg.max_new_tokens):
                r.state = ReqState.FINISHED
                r.t_finish = now if now is not None else t1
                finished.append(r)
                self._free_slot(i)
        return finished

    def _gather_ctx_kv(self, slot: int, ctx: int):
        """Contiguous (L, ctx_pad, Hkv, hd) copies of this slot's pages."""
        n_pages = (ctx + self.cfg.page_size - 1) // self.cfg.page_size
        n_pages = max(n_pages, 1)
        pages = self._tensor(self.block_tables[slot][:n_pages], torch.long)
        shape = (self.arch.n_layers, n_pages * self.cfg.page_size,
                 self.arch.n_kv_heads, -1)
        return (self.kv_k[:, pages].reshape(shape),
                self.kv_v[:, pages].reshape(shape))

    def _write_kv(self, slot: int, start: int, ks, vs) -> None:
        n = ks.shape[1]
        pos = np.arange(start, start + n)
        pages = self._tensor(self.block_tables[slot][pos // self.cfg.page_size],
                             torch.long)
        offs = self._tensor(pos % self.cfg.page_size, torch.long)
        self.kv_k[:, pages, offs] = ks.to(self.kv_k.dtype)
        self.kv_v[:, pages, offs] = vs.to(self.kv_v.dtype)

    def _run_prefill(self, req: Request) -> None:
        s = req.l_in
        slot = self._alloc_slot(req, s + 8)
        toks = list(req.tokens[:s]) if req.tokens else \
            list(np.random.default_rng(req.id).integers(
                2, self.arch.vocab, s))
        req.tokens = [int(t) for t in toks]
        cchunk = self.cfg.prefill_chunk
        if cchunk and s > cchunk:
            # Sarathi-style: process the prompt in fixed-size chunks, each
            # attending to the already-written context pages
            logits = None
            done = 0
            while done < s:
                n = min(cchunk, s - done)
                bucket = max(8, 1 << (n - 1).bit_length())
                chunk = toks[done:done + n] + [0] * (bucket - n)
                k_ctx, v_ctx = self._gather_ctx_kv(slot, max(done, 1))
                # slice to exactly the valid context so chunk positions in
                # the concatenated KV line up with their logical positions
                logits, ks, vs = self._chunk(chunk, k_ctx[:, :done],
                                             v_ctx[:, :done], done, n - 1)
                self._write_kv(slot, done, ks[:, :n], vs[:, :n])
                done += n
        else:
            bucket = max(8, 1 << (s - 1).bit_length())  # pow-2 length buckets
            padded = toks + [0] * (bucket - s)
            logits, cache = self.model.prefill(
                self.params, self._tensor([padded], torch.long),
                logit_pos=s - 1)
            ks, vs = cache[0]["k_big"], cache[0]["v_big"]
            self._write_kv(slot, 0, ks[:, 0, :s], vs[:, 0, :s])
        self.lengths[slot] = s
        req.tokens.append(int(logits.argmax(dim=-1).item()))
        req.l_out = 1      # the prefill emits the first token (TTFT)
