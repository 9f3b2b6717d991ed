"""Architecture configuration (counterpart of repro/configs/base.py, copied:
the port imports nothing of the reference).

Every architecture the port runs has one ``configs/<id>.py`` exporting
``CONFIG`` (the full-size config) and ``SMOKE`` (a reduced variant of the
same family used by the CPU tests). ``get_config`` maps an arch id to
one of them; the port carries the two vision models and the four dense
GQA decoders so far, and every other id raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    arch_type: str                       # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                     # citation for the config numbers

    # trunk
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                    # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # attention flavour
    attention: str = "gqa"               # gqa | mla | none
    rope_theta: float = 10000.0
    use_rope: bool = True
    attn_bias: bool = False
    mlp_bias: bool = False
    logit_soft_cap: float = 0.0

    # MLA (DeepSeek-V2 style latent attention)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # MoE
    moe: bool = False
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                    # per-expert hidden dim
    first_dense_layers: int = 0          # leading dense layers before MoE stack
    moe_every: int = 1                   # MoE layer every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0                 # 0 -> ceil(d_model / 16)

    # hybrid (jamba): one attention layer every `attn_every` layers, rest SSM
    attn_every: int = 0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 1500          # post-conv audio frames

    # modality frontend (stubbed per assignment)
    modality: str = "text"               # text | vision | audio
    num_patches: int = 0                 # vlm: image patch embeddings per example

    # misc
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    mlp: str = "swiglu"                  # swiglu | gelu | relu2
    tie_embeddings: bool = False
    max_seq_len: int = 8192
    sliding_window: int = 0              # 0 = full attention
    dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.ssm_dt_rank or max(1, (self.d_model + 15) // 16)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind string: 'attn' | 'ssm' for the mixer of layer i."""
        kinds = []
        for i in range(self.num_layers):
            if self.arch_type == "ssm":
                kinds.append("ssm")
            elif self.attn_every > 0:
                # jamba: attention at position (attn_every - 1) within each group
                kinds.append("attn" if (i % self.attn_every) == (self.attn_every - 1) else "ssm")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def layer_is_moe(self, i: int) -> bool:
        if not self.moe:
            return False
        if i < self.first_dense_layers:
            return False
        return ((i - self.first_dense_layers) % self.moe_every) == 0

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # Parameter count (analytic, for roofline MODEL_FLOPS)
    def param_counts(self) -> dict:
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        embed = self.vocab_size * d
        per_attn = 0
        if self.attention == "mla":
            qdim = self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
            per_attn = (d * self.q_lora_rank + self.q_lora_rank * qdim
                        + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                        + self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.v_head_dim)
                        + self.num_heads * self.v_head_dim * d)
        elif self.attention == "gqa":
            per_attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
        per_dense_mlp = (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
        mult = 3 if self.mlp == "swiglu" else 2
        per_moe_mlp = ((self.num_experts + self.num_shared_experts) * mult * d * self.moe_d_ff
                       + d * self.num_experts)
        per_moe_active = ((self.top_k + self.num_shared_experts) * mult * d * self.moe_d_ff
                          + d * self.num_experts)
        d_in, st = self.ssm_d_inner, self.ssm_state
        per_ssm = (d * 2 * d_in + d_in * self.ssm_conv
                   + d_in * (self.resolved_dt_rank + 2 * st)
                   + self.resolved_dt_rank * d_in + d_in * st + d_in + d_in * d)
        total = embed + (0 if self.tie_embeddings else embed)
        active = total
        kinds = self.layer_kinds()
        for i, kind in enumerate(kinds):
            mixer = per_ssm if kind == "ssm" else per_attn
            if self.layer_is_moe(i):
                total += mixer + per_moe_mlp
                active += mixer + per_moe_active
            else:
                total += mixer + per_dense_mlp
                active += mixer + per_dense_mlp
        if self.is_encoder_decoder:
            # encoder self-attn + mlp, decoder cross-attn
            total += self.encoder_layers * (per_attn + per_dense_mlp)
            total += self.num_layers * per_attn  # cross attention
            active = total
        return {"total": int(total), "active": int(active)}


ARCH_IDS = (
    "starcoder2-3b", "minitron-8b", "llava-next-mistral-7b", "falcon-mamba-7b",
    "phi4-mini-3.8b", "deepseek-v2-236b", "command-r-35b", "whisper-base",
    "jamba-1.5-large-398b", "kimi-k2-1t-a32b",
)

# the ids the port carries -> module under repro_torch.configs
_MOD = {
    "starcoder2-3b": "starcoder2_3b",
    "minitron-8b": "minitron_8b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "command-r-35b": "command_r_35b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    # paper-native models (vision CNNs for the faithful reproduction)
    "lenet5": "paper_lenet5",
    "resnet18-gn": "paper_resnet18",
}


def get_config(arch_id: str, smoke: bool = False):
    """The ArchConfig (or, for the vision models, VisionConfig) of
    ``arch_id``; SMOKE when ``smoke``."""
    if arch_id not in _MOD:
        if arch_id in ARCH_IDS:
            raise NotImplementedError(
                f"{arch_id} is not ported to repro_torch yet: the port "
                "carries the dense GQA decoders (starcoder2-3b, "
                "phi4-mini-3.8b, minitron-8b, command-r-35b) and the "
                "pure-SSM falcon-mamba-7b; MLA, MoE, hybrid, "
                "encoder-decoder and VLM archs are ROADMAP Queue 1 item "
                "14")
        raise KeyError(f"unknown arch id {arch_id!r}")
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_arch_ids():
    return ARCH_IDS
