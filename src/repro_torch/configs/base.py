"""Typed configuration tree of the port (counterpart of
``repro/configs/base.py``).

The dataclasses keep the reference's field names and defaults for every
knob this slice runs.  Knobs of features not yet ported stay settable so
that a config written for the reference reads the same here, but a
non-default value raises ``NotImplementedError`` naming the ROADMAP item
that ports it — the port never degrades silently.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block-pattern vocabulary (same as the reference)
# ---------------------------------------------------------------------------
MIXERS = ("attn", "attn_sw", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")
BlockSpec = Tuple[str, str]


@dataclass(frozen=True)
class MoEConfig:
    """Routed (and shared) experts of an ``"moe"`` FFN, the reference's
    fields and defaults (``models/moe.py``)."""
    n_routed: int                    # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0                # always-on shared experts (DeepSeek-V2)
    capacity_factor: float = 1.25    # dispatch capacity slack (drops beyond)
    aux_coef: float = 0.01           # load-balance auxiliary loss coefficient
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), the
    reference's fields and defaults.  ``q_lora_rank`` other than None is
    refused (``models.blocks.check_supported``): the reference defines no
    params for a compressed query and projects q at full rank."""
    kv_lora_rank: int                # compressed KV latent dim (c_KV)
    q_lora_rank: Optional[int] = None  # None => full-rank Q projection
    rope_head_dim: int = 64          # decoupled RoPE key dim (d_h^R)
    nope_head_dim: int = 128         # non-RoPE per-head dim (d_h)
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Recurrent mixer parameters (Mamba + xLSTM), the reference's fields
    and defaults.  ``d_state``, ``d_conv``, ``expand``, ``dt_rank`` and
    ``scan_dtype`` serve Mamba (``models/ssm.py``)."""
    d_state: int = 16                # Mamba N (per-channel state)
    d_conv: int = 4                  # Mamba local conv width
    expand: int = 2                  # Mamba inner expansion
    dt_rank: Optional[int] = None    # None => ceil(d_model/16)
    # xLSTM
    mlstm_head_dim: int = 128        # mLSTM matrix-memory head dim (qk dim)
    mlstm_expand: int = 2            # mLSTM up-projection factor
    slstm_heads: int = 4
    mlstm_chunk: int = 64            # chunkwise-parallel chunk length
    scan_dtype: str = "float32"      # Mamba scan-state dtype ("float32"
                                     # or "bfloat16")
    use_pallas_mlstm: bool = False   # True: the hand-written chunkwise
                                     # mLSTM kernel (kernels/mlstm_cuda)


@dataclass(frozen=True)
class VisionStubConfig:
    """VLM frontend stub (anyres tiling), the reference's fields and
    defaults: batches carry ``n_tiles · patches_per_tile`` pre-projected
    patch embeddings of width ``d_model`` (``data.synthetic``), which take
    the place of the first token embeddings (``models.model``)."""
    n_tiles: int = 5                 # anyres: base image + 4 tiles
    patches_per_tile: int = 576      # 24x24 for CLIP-ViT-L/14 @336px
    embed_dim: int = 4096            # after the (stubbed) mm projector


@dataclass(frozen=True)
class AudioStubConfig:
    """Audio frontend stub (conv feature extractor), the reference's
    fields: batches carry 20 ms frame embeddings of width ``d_model``
    directly (``data.synthetic``)."""
    frame_dim: int = 1280
    mask_prob: float = 0.08          # HuBERT masked-prediction span starts
    mask_span: int = 10


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|encoder|moe|vlm|ssm|hybrid
    citation: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # None => d_model // n_heads
    pattern: Tuple[BlockSpec, ...] = (("attn", "dense"),)
    prefix_pattern: Tuple[BlockSpec, ...] = ()
    causal: bool = True
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    post_block_norm: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    vision: Optional[VisionStubConfig] = None
    audio: Optional[AudioStubConfig] = None
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.d_model // self.n_heads)

    @property
    def layers(self) -> Tuple[BlockSpec, ...]:
        body = self.n_layers - len(self.prefix_pattern)
        if body < 0 or (len(self.pattern) and body % len(self.pattern) != 0):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} incompatible with "
                f"prefix={len(self.prefix_pattern)} "
                f"pattern={len(self.pattern)}")
        reps = body // len(self.pattern)
        return self.prefix_pattern + self.pattern * reps

    @property
    def n_scan_blocks(self) -> int:
        return (self.n_layers - len(self.prefix_pattern)) // len(self.pattern)

    def validate(self) -> "ModelConfig":
        for mixer, ffn in self.layers:
            if mixer not in MIXERS:
                raise ValueError(f"unknown mixer {mixer!r}")
            if ffn not in FFNS:
                raise ValueError(f"unknown ffn {ffn!r}")
            if ffn == "moe" and self.moe is None:
                raise ValueError("moe block requires MoEConfig")
            if mixer in ("mamba", "mlstm", "slstm") and self.ssm is None:
                raise ValueError(f"{mixer} block requires SSMConfig")
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        return self

    def has_mixer(self, *kinds: str) -> bool:
        return any(m in kinds for m, _ in self.layers)

    @property
    def supports_long_context(self) -> bool:
        """True if decode with a 500k context is sub-quadratic or of
        bounded state in every layer (SSM/hybrid), or all attention is
        sliding-window."""
        for mixer, _ in self.layers:
            if mixer == "attn":
                return False
        return True

    @property
    def is_encoder(self) -> bool:
        return not self.causal


# ---------------------------------------------------------------------------
# Distribution / decentralized-training config (the paper's knobs)
# ---------------------------------------------------------------------------
TOPOLOGIES = ("ring", "grid", "exp", "one_peer_exp", "full", "disconnected",
              "directed_ring", "directed_exp")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"repro_torch: {what} is not ported yet (ROADMAP {item})")


@dataclass(frozen=True)
class DistConfig:
    algorithm: str = "gossip_pga"
    topology: str = "one_peer_exp"
    H: int = 6                       # global averaging period
    node_axis: str = "data"          # "data": nodes along the mesh's
                                     # (pod, data) axes; "pod": nodes are
                                     # pods
    # SlowMo (Wang et al. 2019) — Gossip-PGA == SlowMo(beta=0, alpha=1)
    slowmo_beta: float = 0.0
    slowmo_lr: float = 1.0
    # Hier-PGA: intra-pod averaging period (the global one is H)
    hier_h_pod: int = 3
    n_pods: int = 2                  # pod blocks of the pod_avg round
    # Gossip-AGA (paper Alg. 2)
    aga_h_init: int = 4
    aga_warmup: int = 64             # K_w warmup iterations of the F_init
                                     # running average
    aga_h_max: int = 64              # Corollary 1 requires bounded H
    # Mesh axes
    data_axis: str = "data"
    model_axis: str = "model"        # tensor-parallel mesh axis: on a mesh
                                     # that has it, the sharded rounds run
                                     # 2-D (node, model), the packed
                                     # columns sliced over it
    pod_axis: str = "pod"
    comm_dtype: str = "float32"      # "bfloat16": bf16 wire cast
    comm_backend: str = "reference"  # "reference": roll/mean mixing
                                     # "pallas": the fused hand-written
                                     # CUDA kernel (kernels/mixing_cuda)
    comm_compression: str = "none"   # gossip wire codec: none | identity |
                                     # int8 | fp8 | topk | randk
                                     # (repro_torch.compress)
    comm_compression_k: int = 32     # elements kept per node per leaf by
                                     # topk/randk
    comm_global_compression: str = "none"
                                     # compressed collective of the global/
                                     # pod_avg phases: none | identity |
                                     # int8 | fp8
    comm_error_feedback: bool = False
                                     # per-node EF residual memory
                                     # (TrainState.ef_state)
    comm_shard_mode: str = "auto"    # fused backend under a mesh whose
                                     # node axis has several shards
                                     # (Trainer(mesh=...)):
                                     # "auto": the sharded per-shard
                                     #         kernels when it has, the
                                     #         stacked kernels otherwise
                                     # "stacked": always the stacked kernels
                                     # "sharded": require a sharded mesh
    pallas_leaf_threshold: int = 262_144
                                     # per-node elements at which a leaf gets
                                     # its own kernel launch instead of the
                                     # concat staging buffer
    push_sum: bool = False           # push-sum gossip: column-stochastic
                                     # rounds of (x, w), reads de-biased
                                     # by the weight (push_weight slot)
    comm_overlap: bool = False       # overlapped gossip: step t's round
                                     # is applied at step t + 1
    remat: str = "block"             # "none" | "block" (checkpoint per block)
    remat_policy: str = "nothing"    # "nothing" | "dots": what a
                                     # checkpointed block saves besides
                                     # its input (models.blocks.
                                     # make_remat)
    fsdp: bool = False

    def validate(self) -> "DistConfig":
        from repro_torch.core.algo import (algorithm_names, get_algorithm,
                                           push_sum_algorithm_names)
        if self.algorithm not in algorithm_names():
            raise ValueError(
                f"DistConfig.validate: unknown algorithm "
                f"{self.algorithm!r} (expected one of {algorithm_names()})")
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r}")
        if self.H < 1:
            raise ValueError("H must be >= 1")
        if self.node_axis not in ("data", "pod"):
            raise ValueError("node_axis must be 'data' or 'pod'")
        if (not self.model_axis
                or self.model_axis in (self.data_axis, self.pod_axis)):
            raise ValueError(
                f"model_axis must be a mesh axis name distinct from "
                f"data_axis={self.data_axis!r} and "
                f"pod_axis={self.pod_axis!r} (got {self.model_axis!r}) — "
                f"the 2-D comm path slices packed columns over it")
        if self.comm_backend not in ("reference", "pallas"):
            raise ValueError("comm_backend must be 'reference' or 'pallas'")
        if self.comm_dtype not in ("float32", "bfloat16"):
            raise ValueError("comm_dtype must be 'float32' or 'bfloat16'")
        # kept equal to repro_torch.compress.COMPRESSORS and
        # COLLECTIVE_COMPRESSORS (tests pin them, and the reference's)
        if self.comm_compression not in ("none", "identity", "int8", "fp8",
                                         "topk", "randk"):
            raise ValueError(
                f"unknown comm_compression {self.comm_compression!r} "
                "(expected none|identity|int8|fp8|topk|randk)")
        if self.comm_compression_k < 1:
            raise ValueError("comm_compression_k must be >= 1")
        if self.comm_global_compression not in ("none", "identity", "int8",
                                                "fp8"):
            raise ValueError(
                f"unknown comm_global_compression "
                f"{self.comm_global_compression!r} (expected "
                "none|identity|int8|fp8 — sparsifiers cannot ride the "
                "reduce-scatter collective)")
        if self.comm_error_feedback and self.comm_compression in (
                "none", "identity") and self.comm_global_compression in (
                "none", "identity"):
            raise ValueError("comm_error_feedback requires a lossy "
                             "comm_compression (int8|fp8|topk|randk) or "
                             "comm_global_compression (int8|fp8)")
        if self.n_pods < 1:
            raise ValueError("n_pods must be >= 1")
        if self.comm_shard_mode not in ("auto", "stacked", "sharded"):
            raise ValueError("comm_shard_mode must be 'auto', 'stacked', "
                             "or 'sharded'")
        if self.pallas_leaf_threshold < 1:
            raise ValueError("pallas_leaf_threshold must be >= 1")
        if self.remat not in ("none", "block"):
            raise ValueError("remat must be 'none' or 'block'")
        if self.remat_policy not in ("nothing", "dots"):
            raise ValueError("remat_policy must be 'nothing' or 'dots'")
        get_algorithm(self.algorithm, caller="DistConfig.validate")
        if self.topology in ("directed_ring", "directed_exp") \
                and not self.push_sum:
            raise ValueError(
                f"topology {self.topology!r} is directed (column-"
                f"stochastic): it requires push_sum=True so reads are "
                f"de-biased by the weight scalar (DESIGN.md §2.5)")
        if self.push_sum:
            push_ok = push_sum_algorithm_names()
            if self.algorithm not in push_ok:
                raise ValueError(
                    f"push_sum composes with algorithms "
                    f"{push_ok}, not {self.algorithm!r}")
            if self.topology == "grid":
                raise ValueError(
                    "push_sum has no 2-D grid decomposition — use a 1-D "
                    "(directed) circulant topology")
            if self.comm_global_compression != "none":
                raise ValueError(
                    "push_sum global rounds average the (x, w) pair over "
                    "the active set and cannot ride the compressed "
                    "collective — set comm_global_compression='none'")
            if self.comm_overlap:
                raise ValueError(
                    "comm_overlap does not compose with push_sum: the "
                    "de-biased read x/w needs x and w mixed by the *same* "
                    "round, but the overlapped correction applies a stale "
                    "buffer to a fresh iterate (DESIGN.md §2.6)")
        if self.fsdp:
            raise not_ported("FSDP parameter sharding (fsdp)", "A.10")
        return self

    def comm_spec(self, n_nodes: int, mesh=None):
        """The port's :class:`repro_torch.core.mixing.CommSpec`, with the
        compressors built and the mesh routing fields set (``mesh``: a
        :class:`repro_torch.core.mesh.Mesh` or None)."""
        import torch

        from repro_torch.compress import make_compressor
        from repro_torch.core.mixing import CommSpec
        return CommSpec(
            topology=self.topology,
            n_nodes=n_nodes,
            n_pods=self.n_pods,
            backend=self.comm_backend,
            mesh=mesh,
            node_axis=self.node_axis,
            model_axis=self.model_axis,
            shard_mode=self.comm_shard_mode,
            leaf_threshold=self.pallas_leaf_threshold,
            comm_dtype=(torch.bfloat16 if self.comm_dtype == "bfloat16"
                        else None),
            compressor=make_compressor(self.comm_compression,
                                       k=self.comm_compression_k),
            global_compressor=make_compressor(
                self.comm_global_compression)).validate()

    def validate_nodes(self, n_nodes: int) -> "DistConfig":
        """Checks that need the runtime node count: at least one node, and
        hier_pga's ``n_pods`` dividing ``n_nodes`` (its pod_avg round needs
        equal pod blocks)."""
        if n_nodes < 1:
            raise ValueError(f"DistConfig: n_nodes={n_nodes} must be >= 1")
        if self.algorithm == "hier_pga" and n_nodes % self.n_pods:
            raise ValueError(
                f"DistConfig: n_pods={self.n_pods} does not divide "
                f"n_nodes={n_nodes} — hier_pga's pod_avg round needs equal "
                f"pod blocks")
        return self


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sgd"                # sgd | adamw | lamb
    lr: float = 0.1
    momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: Optional[float] = 1.0
    schedule: str = "warmup_cosine"  # constant | warmup_cosine |
                                     # warmup_poly | step
    warmup_steps: int = 100
    decay_steps: Tuple[int, ...] = ()
    decay_factor: float = 0.1
    total_steps: int = 1000
    min_lr_ratio: float = 0.0


@dataclass(frozen=True)
class DataConfig:
    kind: str = "synthetic_lm"
    non_iid: bool = True
    non_iid_alpha: float = 0.5
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    dist: DistConfig = field(default_factory=DistConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    global_batch: int = 256
    seq_len: int = 4096
    microbatches: int = 1            # grad-accumulation splits of each
                                     # node's batch
    steps: int = 200
    log_every: int = 10
    ckpt_every: int = 0              # 0 = disabled
    ckpt_dir: str = "/tmp/repro_ckpt"
    seed: int = 0
    z_loss: float = 0.0

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "TrainConfig":
        self.dist.validate()
        if self.microbatches < 1:
            raise ValueError(f"TrainConfig: microbatches="
                             f"{self.microbatches} must be >= 1")
        if self.data.kind != "synthetic_lm":
            # the reference's Trainer ignores the field and trains on the
            # LM stream whatever it says; the port refuses instead
            raise ValueError(
                f"TrainConfig: data kind {self.data.kind!r} — the "
                f"Trainer's stream is LM-only (synthetic_lm); the logistic "
                f"problem runs through repro_torch.core.algorithms."
                f"simulate")
        return self


# ---------------------------------------------------------------------------
# Assigned input shapes (the dry-run's step kinds)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",  524_288,    1, "decode"),
}
