"""Minitron-8B [arXiv:2407.14679] — pruned Nemotron-4: GQA kv=8, RoPE, squared-ReLU MLP."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", arch_type="dense", source="arXiv:2407.14679",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256000,
    attention="gqa", use_rope=True, rope_theta=1e4,
    mlp="relu2", norm="layernorm",
    max_seq_len=4096,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, max_seq_len=512,
)
