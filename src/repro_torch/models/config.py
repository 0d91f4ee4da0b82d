"""Model configuration: the port's own copy of ``repro.models.config``.

One decoder-stack config expresses dense GQA transformers, MoE, SSM
(Mamba2/SSD), hybrids and modality-stub frontends, field for field as in the
JAX package, so a config built for one package reads the same in the other.
The port runs all ten archs of ``repro_torch.configs``: the ``attn``,
``ssm`` and ``ssm+shared_attn`` block patterns, MoE layers, the
``vlm_stub`` and ``audio_stub`` frontends, sinusoidal positions and
parameters in float32, bfloat16 or float16. The TPU roofline constants of
the JAX module are left out: H100 values come with the port of the
planning tools.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    # dimensions
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0            # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1000
    # block structure
    block_pattern: str = "attn"  # "attn" | "ssm" | "ssm+shared_attn"
    shared_attn_every: int = 6   # zamba2: shared attention block period
    # attention details
    rope_theta: float = 10000.0
    pos_embedding: str = "rope"  # rope | sinusoidal (musicgen)
    window: int = 0              # sliding-window size; 0 = full attention
    local_global_pattern: bool = False  # gemma2: alternate local/global layers
    attn_softcap: float = 0.0    # gemma2: 50.0
    final_softcap: float = 0.0   # gemma2: 30.0
    qk_norm: bool = False
    post_norm: bool = False      # gemma2: sandwich (pre+post) block norms
    # MLP
    activation: str = "silu"     # silu (SwiGLU) | gelu (GeGLU)
    # MoE (num_experts == 0 -> dense MLP)
    num_experts: int = 0
    top_k: int = 1
    moe_d_ff: int = 0            # per-expert hidden; 0 -> d_ff
    shared_expert_d_ff: int = 0  # qwen2-moe: 4 shared experts fused into one FFN
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_groups: int = 16         # dispatch groups (= data shards): routing,
                                 # rank-cumsum and capacity buffers are built
                                 # per group so the scatter stays shard-local
                                 # (a global scatter makes GSPMD replicate +
                                 # all-reduce the whole dispatch buffer)
    # SSM (Mamba2 / SSD)
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # embeddings / head
    tie_embeddings: bool = True
    scale_embeddings: bool = False  # gemma: x * sqrt(d_model)
    vocab_pad_to: int = 256
    # frontend stub
    frontend: str = "none"       # none | vlm_stub | audio_stub
    frontend_dim: int = 0        # precomputed patch/frame embedding width
    frontend_len: int = 0        # number of prefix embedding positions (vlm)
    # numerics
    norm_eps: float = 1e-6
    ce_chunks: int = 8           # sequence chunks for the CE loss (big-vocab
                                 # archs: logits never materialize beyond S/chunks)
    attn_direct_max: int = 2048  # S above this -> chunked online-softmax attention
    attn_kv_block: int = 1024    # KV block for the chunked path
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    remat_group: int = 2         # layers per checkpoint block (stash / group)
    scan_layers: bool = True     # False: unroll the layer loop. Required with
                                 # FSDP: GSPMD rewrites gather(slice(xs)) ->
                                 # slice(gather(xs)) and hoists the full-stack
                                 # all-gather out of a scan; straight-line code
                                 # gathers one layer at a time.
    # sharding mode: "tp" (weights replicated over data) or "tp+fsdp"
    # (master weights/moments additionally sharded over the data axis)
    sharding_mode: str = "tp"
    # training
    seq_len: int = 512
    global_batch: int = 8

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab + p - 1) // p * p

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def block_kinds(self) -> list[str]:
        if self.block_pattern == "attn":
            return ["attn"] * self.n_layers
        if self.block_pattern == "ssm":
            return ["ssm"] * self.n_layers
        if self.block_pattern == "ssm+shared_attn":
            return ["ssm"] * self.n_layers  # shared attn is interleaved, not a layer
        raise ValueError(self.block_pattern)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=2 if self.block_pattern == "attn" else 3,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16 if self.head_dim else 0,
            d_ff=128,
            vocab=503,
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            moe_groups=1,
            moe_d_ff=32 if self.num_experts else 0,
            shared_expert_d_ff=64 if self.shared_expert_d_ff else 0,
            ssm_state=16,
            ssm_head_dim=16,
            ssm_chunk=16,
            shared_attn_every=2,
            window=8 if self.window else 0,
            frontend_dim=32 if self.frontend != "none" else 0,
            frontend_len=4 if self.frontend == "vlm_stub" else 0,
            seq_len=32,
            global_batch=2,
            remat=False,
            compute_dtype="float32",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
