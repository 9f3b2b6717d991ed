"""Phi-4-mini 3.8B [arXiv:2412.08905] — dense, RoPE, SwiGLU, GQA kv=8."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", arch_type="dense", source="arXiv:2412.08905",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=200064,
    attention="gqa", use_rope=True, rope_theta=1e4,
    mlp="swiglu", norm="rmsnorm", tie_embeddings=True,
    max_seq_len=131072,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, max_seq_len=512,
)
