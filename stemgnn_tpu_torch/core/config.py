"""Typed configuration tree (counterpart of ``stemgnn_tpu/core/config.py``).

Plain dataclasses with the same fields and defaults as the JAX package, so a
``config.json`` written by either side loads into both through
:func:`from_dict`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class EncoderConfig:
    """Mirrors Encoder(...) kwargs (STEM-GNN/model/encoder.py:132-175)."""
    input_dim: int = 768
    hidden_dim: int = 768
    num_layers: int = 2
    backbone: str = "sage"            # sage | gat | gcn | gin
    normalize: str = "batch"          # none | batch | layer (BatchNorm1d for
                                      # any value other than 'none')
    dropout: float = 0.15
    activation: str = "relu"          # relu | leaky_relu
    moe: bool = False
    num_experts: int = 3
    tau: float = 1.0
    moe_layers: str = "none"          # none | all | last
    compute_dtype: str = "float32"    # float32 | bfloat16
    # Message precision of the fused aggregation path (layout-attached
    # graphs): bf16 messages halve gather/scatter traffic and enable the
    # hub-dense decomposition; accumulation stays f32 either way.
    fused_bf16_messages: bool = True

    @property
    def moe_enabled(self) -> bool:
        return self.moe and self.num_experts > 1

    def moe_layer_flags(self) -> Tuple[bool, ...]:
        """encoder.py:177-189."""
        if not self.moe_enabled or self.moe_layers == "none":
            return tuple([False] * self.num_layers)
        if self.moe_layers == "all":
            return tuple([True] * self.num_layers)
        if self.moe_layers == "last":
            flags = [False] * self.num_layers
            if self.num_layers > 0:
                flags[-1] = True
            return tuple(flags)
        raise ValueError(f"Unsupported moe_layers setting: {self.moe_layers}")


@dataclass(frozen=True)
class VQConfig:
    """Mirrors VectorQuantize(...) kwargs (STEM-GNN/model/vq.py:692-808):
    cosine codebook, separate codebook per head."""
    dim: int = 768
    codebook_size: int = 128
    codebook_dim: int = 768
    heads: int = 4
    separate_codebook_per_head: bool = True
    decay: float = 0.8
    eps: float = 1e-5
    commitment_weight: float = 10.0
    orthogonal_reg_weight: float = 1.0
    orthogonal_reg_max_codes: Optional[int] = 32
    orthogonal_reg_active_codes_only: bool = False
    use_cosine_sim: bool = True
    compute_dtype: str = "float32"
    kmeans_init: bool = False
    kmeans_iters: int = 10
    ema_update: bool = False
    learnable_codebook: bool = False
    threshold_ema_dead_code: float = 0.0
    stochastic_sample_codes: bool = False
    sample_codebook_temp: float = 1.0
    straight_through_gumbel: bool = False
    sync_codebook: bool = False
    # Affine re-parameterization of the euclidean codebook (vq.py:361-411).
    affine_param: bool = False
    affine_param_batch_decay: float = 0.99
    affine_param_codebook_decay: float = 0.9

    @property
    def codebook_input_dim(self) -> int:
        return self.codebook_dim * self.heads

    @property
    def requires_projection(self) -> bool:
        return self.codebook_input_dim != self.dim

    @property
    def num_codebooks(self) -> int:
        return self.heads if self.separate_codebook_per_head else 1

    @property
    def effective_learnable(self) -> bool:
        return self.learnable_codebook or self.orthogonal_reg_weight > 0


@dataclass(frozen=True)
class FinetuneConfig:
    """config/finetune.yaml equivalents."""
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    vq: VQConfig = field(default_factory=lambda: VQConfig(
        kmeans_init=True, commitment_weight=0.25))
    dataset: str = "cora"
    task: str = "node"                # node | link | graph
    epochs: int = 1000
    early_stop: int = 200
    batch_size: int = 0               # 0 = full batch
    lr: float = 5e-4
    repeat: int = 10
    use_vq: bool = True
    freeze_vq: bool = True
    separate_decoder_for_each_head: bool = True
    decoder_jac_coeff: float = 0.0
    lamda_env: float = 0.0
    num_classes: int = 0
    fanout: int = 10
    link_fanout: int = 30
    eval_chunked: bool = False
    eval_edge_block: int = 262_144
    epoch_chunk: int = 16
    # Full-batch graphs carry an ops.edge_layout.EdgeLayout so aggregation
    # runs the fused scatter kernel + hub-dense path; hub_size caps the dense
    # count block (0 disables hubs).  Requires the sage backbone.
    use_fused_layout: bool = True
    hub_size: int = 2048
    # Scatter-side hub blocks (HubDense.sc_*); 0 disables.
    sc_hub_size: int = 2048
    eval_every: int = 1
    eval_bf16: bool = False
    eval_batch_size: int = 0
    eval_train_auc: bool = True
    # Node reordering for gather locality (train/graph_setup.
    # maybe_reorder_dataset): "auto" checks the in-kernel gather gate on the
    # original graph; the relabelling methods are not ported yet.
    reorder: str = "auto"


def _update(dc, d: dict):
    names = {f.name for f in dataclasses.fields(dc)}
    sub = {}
    for k, v in d.items():
        if k not in names:
            continue
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            sub[k] = _update(cur, v)
        else:
            sub[k] = v
    return dataclasses.replace(dc, **sub)


def from_dict(cls_or_default, d: dict):
    """Build a config from a (possibly partial, possibly nested) dict."""
    dc = (cls_or_default if dataclasses.is_dataclass(cls_or_default)
          else cls_or_default())
    return _update(dc, d)
