"""Mamba-2 block (SSD), ported from ``repro.models.mamba2``: full-sequence
prefill and training through ``ssd_scan`` (kernel B4 on CUDA, with its
backward kernel under autograd) and the recurrent one-token decode through
``ssd_decode_step`` (plain torch, as in the reference).

Tensor-parallel layout, as the reference's: the x/z/dt projections and
the SSD heads are sharded over the ``model`` axis ("d_inner" /
"ssm_heads"); the B/C projections (shared across heads) are replicated.
The depthwise convolutions, B4 and the decode recurrence act on each
channel or head alone, so they run on each rank's shard through
``local_map``; the gated RMSNorm reduces over the sharded d_inner
(DTensor's reduction, a small all-reduce of per-token sums). out_proj is
row-parallel.

Cache = (ssm_state (B, H, P, N) fp32, conv_x (B, d_conv-1, di) bf16,
conv_bc (B, d_conv-1, 2GN) bf16); the conv windows are bf16 whatever the
parameter dtype, as in the reference."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import NO_POLICY, Policy
from repro_torch.kernels.ssd_scan import ssd_decode_step, ssd_scan
from repro_torch.models.common import _silu

_DI = ("batch", None, "d_inner")
_HEADS = ("batch", None, "ssm_heads", None)


@dataclasses.dataclass
class MambaCache:
    ssm_state: torch.Tensor    # (..., B, H, P, N) fp32
    conv_x: torch.Tensor       # (..., B, d_conv-1, di) bf16
    conv_bc: torch.Tensor      # (..., B, d_conv-1, 2*G*N) bf16

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        # not dataclasses.astuple, which deep-copies every tensor
        return self.ssm_state, self.conv_x, self.conv_bc

    def map(self, fn) -> "MambaCache":
        return MambaCache(*(fn(t) for t in self.leaves()))

    @staticmethod
    def stack(caches) -> "MambaCache":
        return MambaCache(*(torch.stack(ts) for ts in
                            zip(*(c.leaves() for c in caches))))


def make_mamba_cache(batch: int, arch, device=None) -> MambaCache:
    s = arch.ssm
    return MambaCache(
        ssm_state=torch.zeros((batch, arch.n_ssm_heads, s.head_dim,
                               s.d_state), dtype=torch.float32,
                              device=device),
        conv_x=torch.zeros((batch, s.d_conv - 1, arch.d_inner),
                           dtype=torch.bfloat16, device=device),
        conv_bc=torch.zeros((batch, s.d_conv - 1, 2 * s.ngroups * s.d_state),
                            dtype=torch.bfloat16, device=device))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus (logaddexp(x, 0)) op for op."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _gated_rmsnorm(y, z, w, eps):
    dt = y.dtype
    y = y.float() * _silu(z.float())
    var = y.square().mean(dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + eps) * w.float()).to(dt)


def _causal_depthwise_conv(seq, w, b):
    """seq: (B, S, C); w: (d_conv, C): causal (zero-padded on the left)
    depthwise convolution, as the reference's ``conv_general_dilated``."""
    inp = F.pad(seq, (0, 0, w.shape[0] - 1, 0))
    out = F.conv1d(inp.transpose(1, 2), w.to(seq.dtype).T[:, None, :],
                   groups=w.shape[1])
    return out.transpose(1, 2) + b


def _conv_silu(seq, w, b, policy: Policy, channels):
    """silu(causal depthwise conv) on each rank's channels."""
    ax = ("batch", None, channels)
    return policy.local(
        lambda s_, w_, b_: _silu(_causal_depthwise_conv(s_, w_, b_)),
        (ax, (None, channels), (channels,)), ax)(seq, w, b)


def mamba_block_full(x, p, arch, policy: Policy = NO_POLICY, *,
                     return_cache: bool = False):
    """x: (B, S, D) -> (B, S, D) [, MambaCache]. Prefill starts from a
    zero state and zero conv windows (the reference's ``init_cache`` has no
    caller)."""
    s_cfg = arch.ssm
    b, s, _ = x.shape
    di = arch.d_inner
    nh = arch.n_ssm_heads
    pad = s_cfg.d_conv - 1

    z = x @ p["w_z"]                                   # (B, S, di)
    xr = x @ p["w_x"]                                  # (B, S, di)
    bc = x @ p["w_bc"]                                 # (B, S, 2GN)
    dt_raw = x @ p["w_dt"] + p["dt_bias"]              # (B, S, nh)
    z = policy.constrain(z, _DI)
    xr = policy.constrain(xr, _DI)

    xc = _conv_silu(xr, p["conv_wx"], p["conv_bx"], policy, "d_inner")
    bcc = _conv_silu(bc, p["conv_wbc"], p["conv_bbc"], policy, None)
    xc = policy.constrain(xc, _DI)

    gn = s_cfg.ngroups * s_cfg.d_state
    Bm, Cm = bcc[..., :gn], bcc[..., gn:]
    dt = _softplus(dt_raw.float())
    A = -torch.exp(p["A_log"].float())
    grp = ("batch", None, None, None)

    def scan(x_, dt_, a_, b_, c_, d_):
        return ssd_scan(x_.contiguous(), dt_, a_, b_.contiguous(),
                        c_.contiguous(), d_.contiguous(), chunk=s_cfg.chunk)
    y, final_state = policy.local(
        scan, (_HEADS, ("batch", None, "ssm_heads"), ("ssm_heads",), grp,
               grp, ("ssm_heads",)),
        [_HEADS, ("batch", "ssm_heads", None, None)])(
        xc.reshape(b, s, nh, s_cfg.head_dim), dt, A,
        Bm.reshape(b, s, s_cfg.ngroups, s_cfg.d_state),
        Cm.reshape(b, s, s_cfg.ngroups, s_cfg.d_state), p["D"].float())
    y = _gated_rmsnorm(y.reshape(b, s, di), z, p["norm_w"], arch.norm_eps)
    out = y @ p["w_out"]
    if return_cache:
        def take(t):
            if s < pad:
                t = F.pad(t, (0, 0, pad - s, 0))
            return t[:, -pad:, :].to(torch.bfloat16)
        return out, MambaCache(ssm_state=final_state, conv_x=take(xr),
                               conv_bc=take(bc))
    return out


def mamba_block_decode(x, cache: MambaCache, p, arch,
                       policy: Policy = NO_POLICY
                       ) -> Tuple[torch.Tensor, MambaCache]:
    """One-token step. x: (B, D) -> (B, D)."""
    s_cfg = arch.ssm
    b, _ = x.shape
    di = arch.d_inner
    nh = arch.n_ssm_heads

    z = x @ p["w_z"]                                   # (B, di)
    xr = x @ p["w_x"]
    bc = x @ p["w_bc"]
    dt_raw = x @ p["w_dt"] + p["dt_bias"]              # (B, nh)

    win_x = torch.cat([cache.conv_x.to(xr.dtype), xr[:, None]], dim=1)
    win_bc = torch.cat([cache.conv_bc.to(bc.dtype), bc[:, None]], dim=1)

    def conv_step(win, w, b_):
        return _silu(torch.einsum("bkc,kc->bc", win, w.to(win.dtype)) + b_)
    xc = policy.local(conv_step, (_DI, (None, "d_inner"), ("d_inner",)),
                      ("batch", "d_inner"))(win_x, p["conv_wx"], p["conv_bx"])
    bcc = policy.local(conv_step, (("batch", None, None), (None, None),
                                   (None,)), ("batch", None))(
        win_bc, p["conv_wbc"], p["conv_bbc"])

    gn = s_cfg.ngroups * s_cfg.d_state
    Bm, Cm = bcc[..., :gn], bcc[..., gn:]
    dt = _softplus(dt_raw.float())
    A = -torch.exp(p["A_log"].float())
    state = ("batch", "ssm_heads", None, None)
    grp = ("batch", None, None)
    y, new_state = policy.local(
        ssd_decode_step, (state, ("batch", "ssm_heads", None),
                          ("batch", "ssm_heads"), ("ssm_heads",), grp, grp,
                          ("ssm_heads",)),
        [("batch", "ssm_heads", None), state])(
        cache.ssm_state, xc.reshape(b, nh, s_cfg.head_dim), dt, A,
        Bm.reshape(b, s_cfg.ngroups, s_cfg.d_state),
        Cm.reshape(b, s_cfg.ngroups, s_cfg.d_state), p["D"].float())
    y = _gated_rmsnorm(y.reshape(b, di), z, p["norm_w"], arch.norm_eps)
    out = y @ p["w_out"]
    return out, MambaCache(ssm_state=new_state,
                           conv_x=win_x[:, 1:].to(torch.bfloat16),
                           conv_bc=win_bc[:, 1:].to(torch.bfloat16))
