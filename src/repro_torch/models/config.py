"""Unified model configuration covering all 10 assigned architectures.

A copy of the reference's ``ModelConfig`` (``repro/models/config.py``),
field for field, so a configuration means the same thing in both
packages.  One frozen dataclass describes dense / MoE / SSM / hybrid /
enc-dec / VLM families.  Layers are organized as a repeating *block
program* of period ``block_period``; parameters are stacked over the
``num_blocks`` identical blocks, and the port runs them in a Python loop.
The execution fields (``scan_blocks``, ``remat``, ``use_pallas``, the
Mamba and sharding levers) are kept for the copy's sake and read nowhere
here."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
Mixer = Literal["attn", "mamba", "rwkv"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                     # 0 -> d_model // num_heads

    # attention details
    qkv_bias: bool = False
    parallel_block: bool = False          # Cohere/command-r: x+attn(ln)+mlp(ln)
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_every: int = 1                    # MoE FFN on layers l % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # hybrid (jamba): attention on positions p % attn_every == attn_offset
    attn_every: int = 0                   # 0 -> all layers attention
    attn_offset: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # rwkv6
    rwkv_head_size: int = 64

    # enc-dec
    encoder_layers: int = 0               # >0 -> encoder-decoder

    # modality frontend STUB (audio frames / vision patches): input_specs()
    # provides precomputed embeddings of this many positions
    frontend: str | None = None           # None | "frames" | "patches"
    frontend_positions: int = 0

    # execution
    scan_blocks: bool = True
    remat: bool = True
    use_pallas: bool = False              # TPU kernels (tests use interpret)
    # sequence-parallel attention for head counts that don't divide the
    # model axis (§Perf lever; default off = baseline hd-sharding fallback)
    seqpar_attention: bool = False
    # compute the SSM discretization (exp(Δ·A), Δ·B·x) per scan step
    # instead of materializing [B,T,d_inner,d_state] tensors — the Mamba
    # CUDA kernel's fusion, as a §Perf lever (default off = baseline)
    mamba_fused_discretization: bool = False
    # Megatron-style sequence parallelism: the residual stream is sharded
    # over the model axis between blocks, dividing saved-activation memory
    # by tp (§Perf lever for large-model low-microbatch training)
    seq_sharded_residual: bool = False
    dtype: str = "bfloat16"

    # -- derived -------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md §7)."""
        return self.family in ("ssm", "hybrid")

    @property
    def block_period(self) -> int:
        periods = [1]
        if self.attn_every:
            periods.append(self.attn_every)
        if self.num_experts:
            periods.append(self.moe_every)
        import math
        p = 1
        for q in periods:
            p = p * q // math.gcd(p, q)
        return p

    @property
    def num_blocks(self) -> int:
        assert self.num_layers % self.block_period == 0, (
            f"{self.name}: num_layers {self.num_layers} not divisible by "
            f"block period {self.block_period}")
        return self.num_layers // self.block_period

    def mixer_at(self, pos: int) -> Mixer:
        """Mixer type for position ``pos`` within a block."""
        if self.family == "ssm":
            return "rwkv"
        if self.attn_every:
            return "attn" if pos % self.attn_every == self.attn_offset else "mamba"
        return "attn"

    def ffn_at(self, pos: int) -> str:
        if self.num_experts and pos % self.moe_every == self.moe_offset:
            return "moe"
        return "dense"

    def block_program(self) -> list[tuple[Mixer, str]]:
        return [(self.mixer_at(p), self.ffn_at(p)) for p in range(self.block_period)]

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    # -- parameter counting (6ND roofline term) -------------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, h, hkv = self.head_dim, self.num_heads, self.num_kv_heads
        attn = d * hd * h + 2 * d * hd * hkv + hd * h * d
        if self.qkv_bias:
            attn += hd * (h + 2 * hkv)
        dense_ffn = 3 * d * f
        moe_k = self.experts_per_token if active_only else self.num_experts
        moe_ffn = moe_k * 3 * d * f + d * self.num_experts  # + router
        moe_ffn += self.num_shared_experts * 3 * d * f
        di, ds = self.mamba_d_inner, self.mamba_d_state
        mamba = d * 2 * di + di * self.mamba_d_conv + \
            di * (2 * ds + max(d // 16, 1)) + max(d // 16, 1) * di + di * d
        # rwkv folds channel-mix into the mixer: 5 tm mats + Wcr + cm pair
        rwkv = 5 * d * d + d * d + 2 * d * f
        total = 0
        for (mix, ffn) in self.block_program():
            if mix == "attn":
                total += attn
            elif mix == "mamba":
                total += mamba
            else:
                total += rwkv
            if mix != "rwkv":   # rwkv's FFN is its channel-mix (counted above)
                total += moe_ffn if ffn == "moe" else dense_ffn
            total += 2 * d  # norms
        total *= self.num_blocks
        if self.encoder_layers:
            enc = self.encoder_layers * (attn + dense_ffn + 2 * d)
            dec_cross = self.num_layers * (attn + d)  # cross-attention
            total += enc + dec_cross
        total += v * d * (1 if self.tie_embeddings else 2)
        return total
