"""Config system: model / shape / parallelism / training dataclasses (a copy
of the reference's ``repro.configs.base``; the port imports nothing of it).

Every assigned architecture gets a ``configs/<arch>.py`` exporting
``CONFIG: ModelConfig`` (the exact published shape, cited) and
``smoke_config() -> ModelConfig`` (a reduced same-family variant for CPU
tests: ≤2 layers, d_model ≤ 512, ≤4 experts).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int  # hidden dim of each expert's FFN


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    sliding_window: int = 0  # 0 = full attention (native SWA if > 0)
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    # MoE
    moe: Optional[MoEConfig] = None
    # SSM (mamba2)
    ssm: Optional[SSMConfig] = None
    # hybrid (recurrentgemma): layer-type pattern tiled over n_layers
    hybrid_pattern: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    local_window: int = 2048  # hybrid local-attention window
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    cross_attention: bool = False
    # modality frontend stub
    frontend: str = "none"  # none|audio|vision
    n_frontend_tokens: int = 0  # 1500 audio frames / 256 vision patches
    # numerics
    dtype: str = "bfloat16"
    # sub-quadratic variant used only for the long_500k decode shape on
    # otherwise-full-attention archs (0 = use native attention)
    long_context_window: int = 0
    source: str = ""  # citation

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layer_kind(self, i: int) -> str:
        if self.family == "ssm":
            return "ssm"
        if self.hybrid_pattern:
            return self.hybrid_pattern[i % len(self.hybrid_pattern)]
        return "attn"

    # Parameter counts: repro_torch.models.transformer.count_params
    # (from the parameter shapes alone — no allocation).


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train|prefill|decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How the paper's technique + sharding are applied."""

    agg_method: str = "median"  # mean|median|trimmed_mean|approx_median|approx_trimmed_mean
    agg_beta: float = 0.1
    agg_strategy: str = "gather"  # gather|bucketed|hierarchical|chunked|psum (paper-faithful default; psum = plain DP mean, no robustness)
    param_mode: str = "replicated"  # replicated|fsdp (fsdp = robust reduce-scatter in bwd)
    remat: bool = True
    attn_chunk: int = 1024  # kv-block size for chunked attention (0 = plain)
    agg_dtype: str = ""  # '' = aggregate in gradient dtype
    seq_parallel: bool = False  # sequence parallelism between layers
    # communication rounds (repro_torch.rounds): τ local SGD steps between
    # robust aggregations — 1 = aggregate every step (Algorithm 1); >1
    # scans τ local steps inside the train step so the collective fires
    # once per round (τ× fewer collective rounds; DESIGN.md
    # §Communication rounds)
    local_steps: int = 1
    local_lr: float = 0.1  # local SGD lr used when local_steps > 1
    # gradient compression (repro_torch.rounds.compression): codec applied to
    # each worker's transmitted payload before the collective — attacks
    # act on the decoded wire values.  Error-feedback schemes (topk)
    # need the trainer's window state; make_train_step rejects them.
    compression: str = "none"  # none|int8|topk|count_sketch


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"  # sgd|momentum|adamw
    lr: float = 3e-4
    weight_decay: float = 0.0
    momentum: float = 0.9
    steps: int = 100
    seed: int = 0
    attack: str = "none"
    attack_alpha: float = 0.0
    # device-steps window: the trainer (launch.trainer) scans this many
    # micro-steps on-device per host round-trip — zero host syncs inside
    # the window.  steps must be a multiple of it.  1 = step-by-step.
    device_steps: int = 1
