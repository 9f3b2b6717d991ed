"""Falcon-Mamba-7B [arXiv:2410.05355] — pure Mamba-1, attention-free."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", arch_type="ssm", source="arXiv:2410.05355",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65024,
    attention="none", use_rope=False,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    norm="rmsnorm", mlp="swiglu",     # mlp unused: mamba block is the whole layer
    max_seq_len=1_048_576,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, vocab_size=512, ssm_state=8, max_seq_len=512,
)
