"""PyTorch / CUDA port of the ComParX reference package ``repro``.

Each module mirrors its counterpart in ``src/repro`` by path and name.  The
port imports ``torch`` and nothing of ``repro`` or JAX.  Entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU.
"""
