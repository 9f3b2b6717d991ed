"""Kimi-K2 1T-A32B [arXiv:2501.kimi2] — trillion-param MoE 384e top-8 (+1 shared)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", arch_type="moe", source="arXiv:2501.kimi2",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=18432,                      # dense first layer
    vocab_size=163840,
    attention="gqa", use_rope=True, rope_theta=5e4,
    moe=True, num_experts=384, num_shared_experts=1, top_k=8,
    moe_d_ff=2048, first_dense_layers=1, moe_every=1,
    mlp="swiglu", norm="rmsnorm",
    max_seq_len=131072,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512,
    num_experts=4, num_shared_experts=1, top_k=2, moe_d_ff=128,
    first_dense_layers=1, max_seq_len=512,
)
