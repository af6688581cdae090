"""Model/architecture configuration for the assigned-architecture zoo."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..mpc.errors import InvariantError


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_chunk: int = 2048  # dispatch computed per sequence chunk


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256  # chunked associative scan window


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | vlm | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int             # 0 for attention-free families
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): attention at layer l iff l % attn_every == attn_offset;
    # MoE FFN at layer l iff l % 2 == 1
    attn_every: int = 0
    attn_offset: int = 4
    # encdec (whisper)
    n_enc_layers: int = 0
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # frontends (stubs): number of frontend embedding positions for vlm/audio
    frontend_positions: int = 0
    remat: bool = True
    # hierarchical remat: checkpoint blocks of k layers (outer) with
    # per-layer remat inside the recompute (bounds saved residuals to
    # L/k block inputs + k inner carries; ~3x fwd flops instead of 2x)
    remat_block: int = 1
    # RWKV WKV evaluation: 0 = sequential step scan (paper-faithful
    # recurrence), >0 = chunked-parallel matmul form (identical math,
    # state hits HBM once per chunk — see EXPERIMENTS.md §Perf)
    wkv_chunk: int = 0
    # long-context policy: subquadratic families may run 500k
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def padded_vocab(self, multiple: int = 256) -> int:
        """Vocab padded for clean TP sharding (Megatron-style)."""
        return -(-self.vocab // multiple) * multiple

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE)."""
        d, v = self.d_model, self.padded_vocab()
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        for l in range(self.n_layers):
            total += self._layer_params(l)
        if self.family == "encdec":
            for _ in range(self.n_enc_layers):
                total += self._attn_params() + self._ffn_params(self.d_ff)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        d, v = self.d_model, self.padded_vocab()
        total = v * d * (1 if self.tie_embeddings else 2)
        for l in range(self.n_layers):
            total += self._layer_params(l, active_only=True)
        if self.family == "encdec":
            for _ in range(self.n_enc_layers):
                total += self._attn_params() + self._ffn_params(self.d_ff)
        return total

    # ------------------------------------------------------------- helpers
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        return q + kv + o

    def _ffn_params(self, d_ff: int) -> int:
        return 3 * self.d_model * d_ff  # SwiGLU: w1, w3, w2

    def _ssm_params(self) -> int:
        s = self.ssm or SSMConfig()
        d_in = s.expand * self.d_model
        return (self.d_model * 2 * d_in          # in_proj
                + d_in * s.d_conv                # conv
                + d_in * (2 * s.d_state + 1)     # B, C, dt proj (approx)
                + d_in * s.d_state               # A
                + d_in * self.d_model)           # out_proj

    def _rwkv_params(self) -> int:
        d = self.d_model
        return 4 * d * d + 2 * d * self.d_ff  # time-mix r,k,v,o + channel-mix

    def _layer_params(self, l: int, active_only: bool = False) -> int:
        if self.family in ("dense", "vlm", "encdec"):
            return self._attn_params() + self._ffn_params(self.d_ff)
        if self.family == "moe":
            if self.moe is None:
                raise InvariantError(
                    f"family='moe' config {self.name!r} has no MoEConfig")
            n_e = self.moe.top_k if active_only else self.moe.n_experts
            router = self.d_model * self.moe.n_experts
            return (self._attn_params() + router
                    + n_e * self._ffn_params(self.moe.d_ff_expert)
                    // 1)
        if self.family == "ssm":
            return self._rwkv_params()
        if self.family == "hybrid":
            is_attn = (l % self.attn_every == self.attn_offset
                       if self.attn_every else False)
            mix = self._attn_params() if is_attn else self._ssm_params()
            if self.moe and l % 2 == 1:
                n_e = self.moe.top_k if active_only else self.moe.n_experts
                ffn = (self.d_model * self.moe.n_experts
                       + n_e * self._ffn_params(self.moe.d_ff_expert))
            else:
                ffn = self._ffn_params(self.d_ff)
            return mix + ffn
        raise ValueError(self.family)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}
