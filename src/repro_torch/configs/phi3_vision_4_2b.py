"""phi-3-vision-4.2b [vlm] — phi3-mini + CLIP (frontend STUB)
[hf:microsoft/Phi-3-vision-128k-instruct; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    rope="full", norm="rmsnorm", act="silu", glu=True,
    frontend="patch",
)
