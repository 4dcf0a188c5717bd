"""Timed paths, one module per traffic ``entry``: ``run(ctx)`` builds the
program, warms it up, measures the window and checks what it produced."""
