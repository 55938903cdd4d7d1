"""Configuration dataclasses: the counterparts of ``repro.configs.base``'s
``FedKTConfig`` and ``ModelConfig`` (with ``MoEConfig``, the type of one
of its fields), frozen dataclasses with the same fields and defaults,
and the block kinds of a layer pattern."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds (per-layer mixer type)
# ---------------------------------------------------------------------------
ATTN = "attn"          # softmax attention (GQA; window/softcap via fields)
ATTN_LOCAL = "attn_local"  # sliding-window attention
RGLRU = "rglru"        # RG-LRU recurrence (RecurrentGemma / Griffin)
RWKV = "rwkv"          # RWKV-6 time-mix recurrence


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN settings (GShard-style capacity routing)."""
    num_experts: int = 8
    top_k: int = 2
    num_shared_experts: int = 0      # deepseek-style always-on experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight
    first_k_dense: int = 0           # leading layers that use a dense FFN
    dense_ff_mult: int = 1           # d_ff multiplier for those dense layers


@dataclass(frozen=True)
class ModelConfig:
    """Unified transformer-family model configuration.

    ``pattern`` is a tuple of block kinds tiled across ``num_layers``
    (layer i has kind ``pattern[i % len(pattern)]``)."""
    name: str = "model"
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    pattern: Tuple[str, ...] = (ATTN,)

    # attention details
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0            # stablelm uses partial rotary (0.25)
    window: int = 4096               # sliding window for ATTN_LOCAL blocks
    attn_softcap: float = 0.0        # gemma2 logit soft-capping (0 = off)
    final_softcap: float = 0.0       # gemma2 final-logit soft-capping
    qk_norm: bool = False

    # MLP / MoE
    mlp: str = "swiglu"              # "swiglu" | "geglu" | "gelu" | "relu2"
    moe: Optional[MoEConfig] = None

    # norms & residual structure
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    post_norm: bool = False          # gemma2 post-block norms
    parallel_block: bool = False     # stablelm/gptj style attn+mlp in parallel
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500

    # modality frontend stub (VLM patches / audio frames)
    frontend_embeds: int = 0

    # rwkv dims
    rwkv_head_dim: int = 64

    # recurrentgemma
    rglru_conv_width: int = 4
    rglru_c: float = 8.0

    # numerics
    dtype: str = "bfloat16"          # activation dtype
    param_dtype: str = "float32"

    @property
    def head_dim_(self) -> int:
        return (self.head_dim if self.head_dim
                else self.d_model // self.num_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def num_periods(self) -> int:
        return self.num_layers // len(self.pattern)

    def layer_plan(self) -> Tuple[int, int, Tuple[str, ...]]:
        """(first_k_dense, num_periods, tail_kinds), the reference's
        ``transformer._layer_plan``: ``first_k_dense`` dense head blocks
        of kind ``pattern[0]`` (MoE configs only), then the scanned
        periods of the remaining layers, then their unrolled tail."""
        fkd = self.moe.first_k_dense if self.moe else 0
        remaining, n = self.num_layers - fkd, len(self.pattern)
        return fkd, remaining // n, self.pattern[:remaining % n]

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """The block kind of every layer, in order: the head blocks, the
        reference's scanned periods, then its unrolled tail."""
        fkd, nper, tail = self.layer_plan()
        return (self.pattern[:1] * fkd + self.pattern * nper + tail)


@dataclass(frozen=True)
class FedKTConfig:
    """FedKT algorithm hyper-parameters (paper notation)."""
    num_parties: int = 10            # n
    num_partitions: int = 2          # s
    num_subsets: int = 5             # t
    num_classes: int = 10            # u
    consistent_voting: bool = True
    privacy_level: str = "L0"        # "L0" | "L1" | "L2"
    gamma: float = 0.0               # Laplace scale is 1/gamma (0 = no noise)
    query_fraction: float = 1.0      # fraction of D_aux queried (DP budget)
    beta: float = 0.5                # Dirichlet concentration for partition
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """LM training / distillation hyper-parameters
    (``repro.configs.base.TrainConfig``, every field and default).
    ``pregather`` is the reference's ZeRO-3 bf16 pre-gather switch; on
    one card it is the per-step cast of the float32 masters to
    ``cfg.dtype`` inside the differentiated function, which the port's
    train step always makes (``core/distill.py``)."""
    batch_size: int = 32
    seq_len: int = 128
    learning_rate: float = 1e-3
    weight_decay: float = 1e-6
    epochs: int = 10
    steps: int = 100
    optimizer: str = "adamw"
    warmup_steps: int = 10
    grad_clip: float = 1.0
    remat: bool = True
    microbatches: int = 1   # gradient-accumulation splits of the batch
    pregather: bool = True
    seed: int = 0
