"""granite-8b [dense] — llama-arch, code [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=49152,
    rope="full", norm="rmsnorm", act="silu", glu=True,
)
