"""Config system: model/parallelism/shape dataclasses + registry.

Every assigned architecture registers a :class:`ModelConfig` here. Shapes are
the four assigned (seq_len, global_batch) cells; ``step_kind`` tells the
launcher which program to lower (train_step / prefill / serve_step).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# sub-configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    gating: str = "softmax"
    capacity_factor: float = 1.25
    first_k_dense: int = 0   # deepseek-v3: first 3 layers use dense FFN


@dataclasses.dataclass(frozen=True)
class MLASpec:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    kind: str = "mamba"           # "mamba" | "rwkv6"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # rwkv6
    lora_rank: int = 64           # rwkv6
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How the model maps onto the mesh (DP/FSDP/TP/EP/SP knobs)."""
    fsdp: bool = False                 # shard replicated params over "data"
    scan_layers: bool = True           # lax.scan over stacked layers
    remat: str = "full"                # none | full | dots_saveable
    shard_seq_decode: bool = False     # SP: shard long decode KV over "data"
    quantize_weights: bool = False     # int8 weight path (AMX->MXU analogue)
    optimizer_dtype: str = "float32"   # moments dtype; bf16 halves opt state
    # --- perf-iteration knobs (EXPERIMENTS.md §Perf) ---
    attention_chunk: int = 0           # >0: online-softmax over q chunks of
                                       # this size (never materialize s x s)
    loss_chunk: int = 0                # >0: CE loss over seq chunks (never
                                       # materialize [b, s, vocab] logits)
    dp_over_model: bool = False        # attn-free archs: run batch over the
                                       # model axis too (flat DP + FSDP)
    microbatches: int = 1              # gradient accumulation factor
    decode_cache_carry: bool = False   # decode: cache as scan CARRY with
                                       # per-layer in-place slice updates
                                       # instead of xs/ys full-cache streaming
    zero1: bool = False                # replicate params, shard ONLY the
                                       # optimizer moments over "data"
                                       # (ZeRO-1; for recurrent archs where
                                       # FSDP gathers land inside time scans)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense|moe|hybrid|ssm|encdec|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = True
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    ssm: Optional[SSMSpec] = None
    # hybrid (jamba): one attention layer per `attn_period` layers
    attn_period: int = 0
    moe_period: int = 0                # MoE FFN every `moe_period` layers
    # enc-dec (whisper)
    encoder_layers: int = 0
    decoder_layers: int = 0
    max_target_len: int = 448
    # modality stub: inputs are precomputed embeddings, not token ids
    embedding_inputs: bool = False
    # long-context capability (sub-quadratic mixer) -> long_500k runs
    sub_quadratic: bool = False
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def params_count(self) -> Tuple[int, int]:
        """(total, active) parameter counts — used for MODEL_FLOPS=6ND."""
        d, v, L = self.d_model, self.vocab_size, self.num_layers
        hd = self.head_dim_
        emb = v * d

        def attn_params():
            if self.mla:
                m = self.mla
                return (d * m.q_lora_rank + m.q_lora_rank * self.num_heads * (m.nope_dim + m.rope_dim)
                        + d * (m.kv_lora_rank + m.rope_dim)
                        + m.kv_lora_rank * self.num_heads * (m.nope_dim + m.v_head_dim)
                        + self.num_heads * m.v_head_dim * d)
            return (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                    + self.num_heads * hd * d)

        def dense_ffn():
            return 3 * d * self.d_ff

        def moe_ffn(spec: MoESpec, active: bool):
            e = spec.top_k if active else spec.num_experts
            shared = 3 * d * spec.d_ff_expert * spec.num_shared_experts
            return 3 * d * spec.d_ff_expert * e + shared + d * spec.num_experts

        def ssm_params():
            s = self.ssm
            if s.kind == "rwkv6":
                # time-mix: r,k,v,g,o (5 d^2) + decay lora; channel-mix:
                # w_k (d,ff) + w_v (ff,d) + w_r (d^2)
                return 6 * d * d + 2 * d * s.lora_rank + 2 * d * self.d_ff
            di = s.expand * d
            dr = max(1, (d + 15) // 16)
            return d * 2 * di + di * (2 * s.d_state + dr) + dr * di + di * d

        total = active = emb
        nlayers = self.num_layers if not self.encoder_layers else (
            self.encoder_layers + self.decoder_layers)
        for i in range(nlayers):
            if self.family == "ssm":
                t = a = ssm_params()
            elif self.family == "hybrid":
                is_attn = self.attn_period and (i % self.attn_period == self.attn_period - 1)
                mix = attn_params() if is_attn else ssm_params()
                if self.moe and self.moe_period and (i % self.moe_period == self.moe_period - 1):
                    t = mix + moe_ffn(self.moe, False)
                    a = mix + moe_ffn(self.moe, True)
                else:
                    t = a = mix + dense_ffn()
            elif self.moe:
                t = attn_params() + moe_ffn(self.moe, False)
                a = attn_params() + moe_ffn(self.moe, True)
            else:
                t = a = attn_params() + dense_ffn()
                if self.encoder_layers and i < self.encoder_layers:
                    pass  # encoder layer: same dense shape (cross-attn adds below)
            if self.encoder_layers and i >= self.encoder_layers:
                t += attn_params()  # cross-attention
                a += attn_params()
            total += t
            active += a
        return total, active


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    step_kind: str   # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a cell is lowered (DESIGN.md §5 skips)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: long_500k needs sub-quadratic mixer"
    return True, ""


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs():
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------

def smoke_config(name: str) -> ModelConfig:
    """Tiny same-family config: few layers, narrow width, tiny vocab."""
    cfg = get_config(name)
    kw: dict = dict(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, dtype="float32",
        parallel=dataclasses.replace(cfg.parallel, scan_layers=True),
    )
    if cfg.family == "ssm":
        kw.update(num_layers=2, d_model=64, d_ff=128)
        kw["ssm"] = dataclasses.replace(cfg.ssm, head_dim=16, lora_rank=8, chunk=8)
    # smoke MoE runs dropless (high capacity): parity tests require that
    # prefill/decode see the same expert outputs as teacher-forced forward.
    if cfg.family == "hybrid":
        kw.update(num_layers=cfg.attn_period)  # one full group
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=4, d_conv=4, expand=2, chunk=8)
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4, top_k=2,
                                        d_ff_expert=64, capacity_factor=8.0)
    elif cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
            first_k_dense=min(cfg.moe.first_k_dense, 1), capacity_factor=8.0)
    if cfg.mla is not None:
        kw["mla"] = MLASpec(q_lora_rank=32, kv_lora_rank=16, rope_dim=8,
                            nope_dim=16, v_head_dim=16)
        kw.update(num_heads=4, num_kv_heads=4, head_dim=16)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, decoder_layers=2, max_target_len=16)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
