"""Jamba-1.5-Large 398B [arXiv:2403.19887] — hybrid Mamba+attention (1:7) + MoE 16e top-2.

72 layers in 9 groups of 8 (7 Mamba + 1 attention); MoE every 2nd layer.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", arch_type="hybrid", source="arXiv:2403.19887",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    attention="gqa", use_rope=False,       # jamba: no positional encoding
    attn_every=8,                          # 1 attention per 8 layers (1:7)
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    moe=True, num_experts=16, num_shared_experts=0, top_k=2,
    moe_d_ff=24576, moe_every=2, first_dense_layers=1,
    mlp="swiglu", norm="rmsnorm",
    max_seq_len=262144,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, attn_every=2, ssm_state=8,
    num_experts=4, top_k=2, moe_d_ff=512, moe_every=2, first_dense_layers=1,
    max_seq_len=512,
)
