"""Architecture config schema shared by all assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                     # dense | moe | ssm | hybrid | encoder | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # attention flavor
    causal: bool = True
    rope: bool = True
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    qkv_bias: bool = False

    # block flavor
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    activation: str = "silu"        # silu (SwiGLU) | gelu
    tied_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "expert"    # expert | rank (AWAPart-placed)

    # SSM (mamba2) / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0             # zamba2: shared attn block period (0 = none)

    # RWKV6
    rwkv: bool = False
    rwkv_head_dim: int = 64
    rwkv_lora_dim: int = 64

    # modality frontend stub: inputs are precomputed embeddings, not token ids
    embedding_inputs: bool = False

    # numerics / memory
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    softmax_f32: bool = True        # False: bf16 attention probs, f32 stats
    remat: str = "full"             # full | dots | none
    scan_layers: bool = True
    use_flash: bool = False         # flash-attention kernel path

    # ------------------------------------------------------------------ #
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def sharding_profile(self) -> str:
        """dp (pure data-parallel, ZeRO-1) for small models; fsdp_tp above."""
        return "dp" if self.n_params() <= 1.5e9 else "fsdp_tp"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm" and self.attn_every == 0

    @property
    def has_decode(self) -> bool:
        return self.causal         # encoder-only archs have no decode step

    @property
    def subquadratic(self) -> bool:
        """True if long-context (500k) decode is supported."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        n = self.vocab_size * d                       # embed
        if not self.tied_embeddings:
            n += self.vocab_size * d                  # head
        if self.rwkv:
            per = (2 * d * d                          # r, g (approx; r:d*d, g)
                   + 2 * d * d                        # k, v
                   + d * d                            # output
                   + 6 * d * self.rwkv_lora_dim * 2   # ddlerp + decay loras
                   + d * self.d_ff + self.d_ff * d    # channel mix
                   + 4 * d)
            return n + L * per
        if self.family in ("ssm", "hybrid"):
            d_in = self.ssm_expand * d
            ngroups = 1
            per = (d * (2 * d_in + 2 * ngroups * self.ssm_state
                        + d_in // self.ssm_head_dim)
                   + d_in * d + 3 * d_in)
            n += L * per
            if self.attn_every:
                n_blocks = 1                           # shared (reused) block
                attn = (2 * d) * self.n_heads * hd + \
                    2 * (2 * d) * self.n_kv_heads * hd + self.n_heads * hd * d
                mlp = 3 * d * self.d_ff
                n += n_blocks * (attn + mlp)
            return n
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.is_moe:
            mlp = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        else:
            mlp_mult = 3 if self.activation == "silu" else 2
            mlp = mlp_mult * d * self.d_ff
        return n + L * (attn + mlp + 2 * d)

    def n_active_params(self) -> int:
        if not self.is_moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        dense = self.n_params() - L * self.n_experts * 3 * d * self.d_ff
        return dense + L * self.top_k * 3 * d * self.d_ff

    def reduced(self, n_layers: int = 2, d_model: int = 64,
                vocab: int = 128) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        scale = d_model / self.d_model
        heads = max(1, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, heads))
        return dataclasses.replace(
            self,
            n_layers=n_layers, d_model=d_model,
            n_heads=heads if self.n_heads else 0,
            n_kv_heads=kv if self.n_kv_heads else 0,
            head_dim=d_model // max(heads, 1) if self.head_dim else 0,
            d_ff=max(32, int(self.d_ff * scale) // 8 * 8),
            vocab_size=vocab,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=8,
            attn_every=2 if self.attn_every else 0,
            rwkv_head_dim=16 if self.rwkv else self.rwkv_head_dim,
            rwkv_lora_dim=8 if self.rwkv else self.rwkv_lora_dim,
            remat="none", scan_layers=True,
            compute_dtype="float32",     # CPU smoke tests: avoid bf16 emulation
        )


# input shapes assigned to the LM family (seq_len, global_batch)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def shape_supported(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    """Whether an (arch × shape) cell runs, with the skip reason if not."""
    info = SHAPES[shape]
    if info["kind"] == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch; 500k decode needs sub-quadratic attention"
    return True, ""
