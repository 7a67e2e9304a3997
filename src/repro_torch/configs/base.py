"""Architecture + shape configuration system.

Every assigned architecture is a declarative ``ArchConfig``; the model zoo in
``repro.models`` builds a concrete JAX model from it.  Shapes (the assigned
(arch x input-shape) cells) are ``ShapeSpec``s; ``launch.dryrun`` iterates the
cross product.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    AUDIO = "audio"
    VLM = "vlm"


class PosEmb(str, enum.Enum):
    ROPE = "rope"
    SINUSOIDAL = "sinusoidal"
    NONE = "none"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 0
    n_shared_experts: int = 0     # always-on shared experts
    d_expert: int = 0             # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    n_dense_layers: int = 0       # leading layers that stay dense (DeepSeek-style)
    d_shared: int = 0             # shared-expert hidden size (0 -> d_expert * n_shared)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # mamba2 "P" (per-head channels)
    chunk: int = 256              # SSD chunk length
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int                  # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    pos_emb: PosEmb = PosEmb.ROPE
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"             # silu -> SwiGLU; gelu -> GeGLU
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: attention block applied every `attn_every` layers (shared weights,
    # Zamba2-style); 0 = attention in every layer (dense), -1 = no attention (ssm)
    attn_every: int = 0
    shared_attn_block: bool = False
    # vlm: cross-attention to image tokens every `cross_attn_every` layers
    cross_attn_every: int = 0
    n_frontend_tokens: int = 0    # image/audio-frontend tokens (stub input)
    # data type for params/activations
    param_dtype: str = "bfloat16"
    # source note for provenance
    source: str = ""

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attn_layers(self) -> Sequence[int]:
        """Indices of layers that contain (self-)attention."""
        if self.attn_every == -1:
            return ()
        if self.attn_every == 0:
            return tuple(range(self.n_layers))
        return tuple(i for i in range(self.n_layers)
                     if (i % self.attn_every) == (self.attn_every - 1))

    @property
    def cross_attn_layers(self) -> Sequence[int]:
        if self.cross_attn_every <= 0:
            return ()
        return tuple(i for i in range(self.n_layers)
                     if (i % self.cross_attn_every) == (self.cross_attn_every - 1))

    @property
    def n_attn_layers(self) -> int:
        return len(self.attn_layers)

    @property
    def is_subquadratic(self) -> bool:
        """True if per-token decode state does not grow linearly in every layer
        (SSM / hybrid archs): eligible for the long_500k shape."""
        return self.family in (Family.SSM, Family.HYBRID)

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.head_dim

    # ---- parameter counting (used for roofline MODEL_FLOPS = 6ND) ----------
    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        n_params = 0
        # embeddings (+ untied head)
        n_params += self.vocab * d
        if not self.tie_embeddings:
            n_params += self.vocab * d
        attn_set = set(self.attn_layers)
        cross_set = set(self.cross_attn_layers)
        per_attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        shared_attn_counted = False
        for i in range(L):
            n_params += 2 * d  # norms
            if i in attn_set:
                if self.shared_attn_block:
                    if not shared_attn_counted:
                        n_params += per_attn
                        shared_attn_counted = True
                else:
                    n_params += per_attn
            if i in cross_set:
                n_params += per_attn
            if self.ssm is not None and (self.family == Family.SSM or
                                         (self.family == Family.HYBRID and i not in attn_set)):
                di, s = self.d_inner, self.ssm
                nh = self.n_ssm_heads
                # in_proj: z, x, B, C, dt
                n_params += d * (2 * di + 2 * s.ngroups * s.d_state + nh)
                n_params += s.d_conv * (di + 2 * s.ngroups * s.d_state)  # conv1d
                n_params += 2 * nh  # A_log, D
                n_params += di * d  # out_proj
            if self.d_ff > 0 and (self.moe is None or i < (self.moe.n_dense_layers or 0)
                                  or self.family != Family.MOE):
                n_params += 3 * d * self.d_ff  # SwiGLU: gate, up, down
            elif self.moe is not None and self.family == Family.MOE \
                    and i >= (self.moe.n_dense_layers or 0):
                m = self.moe
                n_experts = m.top_k if active_only else m.n_experts
                n_params += n_experts * 3 * d * m.d_expert
                if m.n_shared_experts:
                    d_sh = m.d_shared or m.d_expert * m.n_shared_experts
                    n_params += 3 * d * d_sh
                n_params += d * m.n_experts  # router
        return n_params

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache bytes appended per generated/prefilled token (all layers)."""
        hd = self.resolved_head_dim
        n_attn = self.n_attn_layers + len(self.cross_attn_layers) * 0  # cross KV is fixed-size
        return n_attn * 2 * self.n_kv_heads * hd * dtype_bytes

    def ssm_state_bytes(self, dtype_bytes: int = 4) -> int:
        """Constant per-sequence recurrent state bytes (SSM/hybrid)."""
        if self.ssm is None:
            return 0
        n_ssm = self.n_layers - (self.n_attn_layers if self.family == Family.HYBRID else 0)
        if self.family == Family.SSM:
            n_ssm = self.n_layers
        per_layer = self.n_ssm_heads * self.ssm.head_dim * self.ssm.d_state \
            + (self.d_inner + 2 * self.ssm.ngroups * self.ssm.d_state) * self.ssm.d_conv
        return n_ssm * per_layer * dtype_bytes


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    kind: str                     # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSpec("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shape_applicable(arch: ArchConfig, shape: ShapeSpec) -> bool:
    """long_500k needs sub-quadratic decode; everything else always applies."""
    if shape.name == "long_500k":
        return arch.is_subquadratic
    return True


def reduced(arch: ArchConfig, n_layers: int = 2, d_model: int = 64,
            vocab: int = 256, n_heads: int = 4, n_kv_heads: int = 2,
            d_ff: int = 128) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests and the real engine."""
    kw: dict = dict(
        name=arch.name + "-smoke", n_layers=n_layers, d_model=d_model,
        vocab=vocab, head_dim=0,
    )
    if arch.n_heads:
        kw.update(n_heads=n_heads,
                  n_kv_heads=min(n_kv_heads, n_heads) if arch.n_kv_heads < arch.n_heads else n_heads)
    else:
        kw.update(n_heads=0, n_kv_heads=0)
    kw["d_ff"] = d_ff if arch.d_ff else 0
    if arch.moe is not None:
        kw["moe"] = dataclasses.replace(
            arch.moe, n_experts=min(arch.moe.n_experts, 8),
            top_k=min(arch.moe.top_k, 2), d_expert=d_ff,
            n_shared_experts=min(arch.moe.n_shared_experts, 1),
            d_shared=d_ff if arch.moe.n_shared_experts else 0,
            n_dense_layers=min(arch.moe.n_dense_layers, 1))
        kw["d_ff"] = 0 if arch.family == Family.MOE else d_ff
    if arch.ssm is not None:
        kw["ssm"] = dataclasses.replace(arch.ssm, d_state=16, head_dim=16, chunk=32)
    if arch.attn_every:
        kw["attn_every"] = 2 if arch.attn_every > 0 else -1
    if arch.cross_attn_every:
        kw["cross_attn_every"] = 2
        kw["n_frontend_tokens"] = 16
    if arch.n_frontend_tokens and not arch.cross_attn_every:
        kw["n_frontend_tokens"] = 16
    return dataclasses.replace(arch, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    from repro_torch import configs  # noqa: F401  (ensures registration modules imported)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> dict[str, ArchConfig]:
    from repro_torch import configs  # noqa: F401
    return dict(_REGISTRY)
