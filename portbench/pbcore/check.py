"""What decides ``correct``.

1. The control plane, by counts: every request that arrived was placed on
   a live worker, and finished with exactly its ``l_real`` tokens (ids in
   the vocabulary), or it counts as failed.
2. The served tokens and the logits they were drawn from, against the
   plain reference: a sample, drawn from the seed, of the finished
   requests, the longest among them, until it holds ``served_tokens``
   served tokens. The reference runs once over each prompt and its served
   tokens, in fp32, from the harness's weights. Two readings:
   ``max_logit_gap``, the widest gap by which a served token's reference
   logit lies below the reference's best at its position (non-zero only
   where a token flips), and ``max_logit_err``, the widest difference
   between a logit the program produced at a served position (its ``TOP``
   highest, which ``LogitTap`` keeps as the engine makes them) and the
   reference's logit of the same token, in units of the standard deviation
   of the reference's logits at that position (continuous: it reads the
   rounding of every run, flipped token or not).

The control is the reference computed one step below the precision the
configuration states for each stage (bf16 -> fp8, fp32 -> tf32), put in
the program's place: its gap is that of the token the lower precision puts
first at each position of the same prompts and tokens, its error that of
its own ``TOP`` highest logits.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

LOWER = {"bfloat16": "fp8", "float32": "tf32"}
TOP = 8


class LogitTap:
    """The program's own logits, as each engine makes them: the ``TOP``
    highest (values and token ids) of every served position, kept on the
    device while the window runs (a top-k over the logits an iteration
    returns, no host read) and read back once it has closed. Installed
    outermost on ``_decode``, ``_chunk`` and the model's ``prefill``, so
    it sees what the engine takes its tokens from."""

    def __init__(self, cluster):
        self.decodes = []        # (values, ids, [(slot, req id, index)])
        self.prefills = []       # (values, ids, req id)
        self._last = []
        self._engines = [w.engine for w in cluster.workers.values()]
        for eng in self._engines:
            self._attach(eng)

    def _attach(self, eng):
        decode, chunk, prefill = eng._decode, eng._chunk, eng.model.prefill
        run_prefill = eng._run_prefill

        def top(logits):
            v, i = logits.detach().topk(TOP, dim=-1)
            return v.reshape(-1, TOP), i.reshape(-1, TOP)

        def tapped_decode(tokens, active):
            logits = decode(tokens, active)
            v, i = top(logits)
            self.decodes.append((v, i, [(s, eng.slots[s].id,
                                         eng.slots[s].l_out)
                                        for s in active]))
            return logits

        def tapped_chunk(*a, **k):
            out = chunk(*a, **k)
            self._last.append(top(out[0]))
            return out

        def tapped_prefill(*a, **k):
            out = prefill(*a, **k)
            self._last.append(top(out[0]))
            return out

        def tapped_run_prefill(req):
            self._last.clear()
            run_prefill(req)
            v, i = self._last[-1]
            self.prefills.append((v, i, req.id))
        eng._decode, eng._chunk = tapped_decode, tapped_chunk
        eng.model.prefill, eng._run_prefill = tapped_prefill, \
            tapped_run_prefill

    def detach(self) -> None:
        for eng in self._engines:
            for name in ("_decode", "_chunk", "_run_prefill"):
                eng.__dict__.pop(name, None)
            eng.model.__dict__.pop("prefill", None)
        self._engines = []

    def rows(self, requests) -> Dict[int, tuple]:
        """{req id: (values, ids)}, (l_real, TOP) on the host, of the
        given finished requests; a position the tap never saw (a step that
        bypassed the engine's own calls) is NaN. A preempted request's
        positions hold their last computation."""
        want = {r.id: r.l_real for r in requests}
        vals = {k: np.full((n, TOP), np.nan, np.float32)
                for k, n in want.items()}
        ids = {k: np.zeros((n, TOP), np.int64) for k, n in want.items()}
        for v, i, rid in self.prefills:
            if rid in want:
                vals[rid][0], ids[rid][0] = v[0].cpu().numpy(), \
                    i[0].cpu().numpy()
        for v, i, live in self.decodes:
            hit = [(s, rid, j) for s, rid, j in live
                   if rid in want and j < want[rid]]
            if not hit:
                continue
            v, i = v.cpu().numpy(), i.cpu().numpy()
            for s, rid, j in hit:
                vals[rid][j], ids[rid][j] = v[s], i[s]
        return {k: (vals[k], ids[k]) for k in want}


def counts(requests, finish: Dict[int, float], live: Sequence[int],
           vocab: int) -> Dict[str, int]:
    """(unplaced, failed, wrong) over the requests that arrived."""
    unplaced = failed = wrong = 0
    for r, _, _ in requests:
        if r.worker is None or r.worker not in live:
            unplaced += 1
        if r.id not in finish:
            failed += 1
            continue
        toks = r.tokens or []
        if r.l_out != r.l_real or len(toks) != r.l_in + r.l_real \
                or not all(0 <= t < vocab for t in toks):
            wrong += 1
    return {"unplaced": unplaced, "failed": failed, "wrong": wrong}


def sample(requests, finish: Dict[int, float], seed: int,
           served_tokens: int) -> List:
    """The longest finished request (prompt and output), then others in
    an order drawn from the seed, until ``served_tokens`` are held."""
    done = [r for r, _, _ in requests if r.id in finish]
    if not done:
        return []
    done.sort(key=lambda r: r.id)
    longest = max(done, key=lambda r: (r.l_in + r.l_real, r.id))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([int(seed), 7]).permutation(len(rest))
    out, held = [longest], longest.l_real
    for i in order:
        if held >= served_tokens:
            break
        out.append(rest[i])
        held += rest[i].l_real
    return out


def stage_precisions(cfg: Dict, chunk: int, l_in: int) -> Tuple[str, str]:
    """(prompt, decode) precision the configuration states for a request:
    a prompt the engine prefills in one shot runs in the one-shot dtype, a
    chunked one in the chunked dtype."""
    p = cfg["precision"]
    one_shot = not chunk or l_in <= chunk
    return (p["one_shot_prefill"] if one_shot else p["chunked_prefill"],
            p["decode"])


def _seqs(reqs, device, precs):
    import torch
    out = []
    for r, pr in zip(reqs, precs):
        toks = torch.as_tensor(r.tokens[:r.l_in + r.l_real - 1],
                               dtype=torch.long, device=device)
        out.append({"tokens": toks, "first": r.l_in - 1,
                    "boundary": r.l_in, "precs": pr})
    return out


def _err(ref_logits, values, ids) -> float:
    """Widest |logit - reference logit| over the given tokens of each
    position, in units of the reference row's standard deviation; NaN
    (a position never seen) reads as infinite."""
    got = ref_logits.gather(1, ids)
    scale = ref_logits.std(dim=-1, keepdim=True)
    err = ((values - got).abs() / scale).nan_to_num(nan=float("inf"))
    return float(err.max())


def readings(ref, weights, cfg, reqs, tapped: Dict[int, tuple], chunk: int,
             device, control: bool = False) -> Dict:
    """The program's ``max_logit_gap`` and ``max_logit_err`` over the
    sample and, with ``control``, the control's; the reference runs in
    blocks of a few sequences."""
    import torch
    stated = [stage_precisions(cfg, chunk, r.l_in) for r in reqs]
    prog = {"max_logit_gap": 0.0, "max_logit_err": 0.0}
    ctrl = dict(prog)
    tokens = 0
    block = 4
    for b in range(0, len(reqs), block):
        part = reqs[b:b + block]
        full = ref.logits(weights, cfg, _seqs(
            part, device, [("fp32", "fp32")] * len(part)))
        low = ref.logits(weights, cfg, _seqs(
            part, device, [tuple(LOWER[p] for p in s)
                           for s in stated[b:b + block]])) \
            if control else [None] * len(part)
        for r, lg, lw in zip(part, full, low):
            sv = torch.as_tensor(r.tokens[r.l_in:r.l_in + r.l_real],
                                 device=lg.device)
            best = lg.max(dim=-1).values
            rows = torch.arange(lg.shape[0], device=lg.device)
            prog["max_logit_gap"] = max(prog["max_logit_gap"], float(
                (best - lg[rows, sv]).max()))
            v, i = (torch.as_tensor(x, device=lg.device)
                    for x in tapped[r.id])
            prog["max_logit_err"] = max(prog["max_logit_err"],
                                        _err(lg, v, i))
            tokens += int(sv.numel())
            if lw is not None:
                cv, ci = lw.topk(TOP, dim=-1)
                ctrl["max_logit_gap"] = max(ctrl["max_logit_gap"], float(
                    (best - lg[rows, ci[:, 0]]).max()))
                ctrl["max_logit_err"] = max(ctrl["max_logit_err"],
                                            _err(lg, cv, ci))
        del full, low
    return {"program": prog, "control": ctrl if control else None,
            "tokens_compared": tokens}
