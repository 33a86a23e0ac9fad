"""Model and run configs plus the arch registry (the port's own copy of the
fields the prefill paths and the cost model read; mirrors
``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    # d_ff of each routed expert (may differ from the dense d_ff)
    d_expert: int = 0
    router_jitter: float = 0.0
    # experts [num_real:] are zero-weight and their router logits are
    # masked: bit-exact with the unpadded model (0 = none)
    num_real_experts: int = 0

    @property
    def real_experts(self) -> int:
        return self.num_real_experts or self.num_experts


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: groups of SSM layers with a shared attention block."""
    ssm_per_group: int = 5
    num_groups: int = 13
    tail_ssm_layers: int = 3

    @property
    def total_layers(self) -> int:
        return self.num_groups * (self.ssm_per_group + 1) + self.tail_ssm_layers


@dataclass(frozen=True)
class EncDecConfig:
    enc_layers: int = 12
    # stubbed audio frontend: precomputed frame embeddings
    num_frames: int = 1500


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend stub: precomputed embeddings injected as inputs."""
    kind: str = "none"  # none | audio_stub | vision_stub
    num_embeds: int = 0  # frames or patches the caller provides


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # Granite-style scalars (1.0 = disabled)
    embedding_multiplier: float = 1.0
    logits_scaling: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0  # 0 -> 1/sqrt(head_dim)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True if the arch can run the 500k-token long-context decode shape."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (the cost model's weight bytes and the
        serving engines' KV capacity)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d + (2 * hd if self.qk_norm else 0))
        block = attn + 3 * d * self.d_ff + 2 * d     # + SwiGLU, two norms
        if self.family in ("dense", "vlm"):
            return emb + self.num_layers * block + d
        if self.family == "encdec":       # decoder layers add cross-attention and its norm
            dec = 2 * attn + 3 * d * self.d_ff + 3 * d
            return emb + self.encdec.enc_layers * block + self.num_layers * dec + 2 * d
        if self.family == "moe":
            m = self.moe
            d_e = m.d_expert or self.d_ff
            per = (attn + d * m.num_experts                       # router
                   + (m.num_experts + m.num_shared_experts) * 3 * d * d_e + 2 * d)
            return emb + self.num_layers * per + d
        s = self.ssm
        d_in = s.expand * d
        nheads = d_in // s.head_dim
        ssm = (d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)   # in_proj
               + s.conv_kernel * (d_in + 2 * s.n_groups * s.d_state)  # conv
               + nheads * 2 + d_in + d_in * d + d)   # A_log, dt_bias, gate norm, out, norm
        if self.family == "ssm":
            return emb + self.num_layers * ssm + d
        h = self.hybrid
        n_ssm = h.num_groups * h.ssm_per_group + h.tail_ssm_layers
        return emb + n_ssm * ssm + block + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        d_e = m.d_expert or self.d_ff
        inactive = (m.num_experts - m.top_k) * 3 * self.d_model * d_e
        return self.param_count() - self.num_layers * inactive

    def kv_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        """KV-cache bytes per token across all attention layers."""
        hd = self.resolved_head_dim
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            n_attn = self.hybrid.num_groups  # shared block applied once per group
            return 2 * n_attn * self.num_kv_heads * hd * bytes_per_el
        return 2 * self.num_layers * self.num_kv_heads * hd * bytes_per_el


@dataclass(frozen=True)
class ShapeConfig:
    """One dry-run shape: what a step does (train | prefill | decode), its
    sequence length and its global batch."""
    name: str
    kind: str
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class RunConfig:
    """The knobs of one chunked-pipeline run that this path reads."""
    num_chunks: int = 16
    num_stages: int = 16
    mbkr: bool = True
    kv_spill_dtype: str = "bfloat16"  # int8 -> wire-only spill compression
    remote_attn: str = "qship"        # fetch | qship
    # self block: "torch" (per-block reference) | "cuda" (kernel K1)
    attn_backend: str = "torch"
    # pool-sourced partials: auto (follows attn_backend) | torch | cuda
    # (slot-stack kernel K2) | paged (in-place page kernel K3)
    pool_backend: str = "auto"
    # SSD inner loop of the ssm / hybrid stage programs: "torch"
    # (``models.ssm.ssd_chunked``) | "cuda" (kernel K4)
    ssm_backend: str = "torch"
    kv_dtype: str = "auto"            # auto | bfloat16 | float32 | int8 | fp8
    kv_page_tokens: int = 0           # 0 = one page per chunk
    # tensor-parallel lowering: auto | manual (explicit psums over an
    # emulated tp axis; ``core.plan.resolve_tp_lowering``)
    tp_lowering: str = "auto"


ATTN_BACKENDS = ("torch", "cuda")
POOL_BACKENDS = ("auto", "torch", "cuda", "paged")
SSM_BACKENDS = ("torch", "cuda")

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _SMOKE_REGISTRY[name] = smoke


def _ensure_loaded() -> None:
    from repro_torch.configs import (granite_3_2b, granite_moe_3b_a800m,  # noqa: F401
                                     llama3_70b, llama3_405b, mamba2_130m,
                                     mistral_123b, qwen2_moe_a2_7b, qwen3_8b,
                                     qwen3_14b, qwen3_235b, stablelm_3b,
                                     whisper_small, llava_next_34b, zamba2_7b)


def get_config(arch: str) -> ModelConfig:
    _ensure_loaded()
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch]()


def get_smoke_config(arch: str) -> ModelConfig:
    _ensure_loaded()
    return _SMOKE_REGISTRY[arch]()


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
