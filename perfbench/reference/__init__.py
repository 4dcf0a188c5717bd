"""The plain reference: a dense attention stack's forward, loss, gradients
and AdamW in float32 PyTorch, and the sweep's fusion as an argmin.  It
imports nothing of the port: it follows the configuration's file and the
published description, with the port's conventions where a choice has no
published answer (interleaved RoPE pairs, norm epsilon 1e-6, tanh GELU,
z-loss 1e-4, AdamW's constants)."""
