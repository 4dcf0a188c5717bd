"""Runtime helpers: logical-axis sharding on a device mesh, and the
program's own spans and counters (``trace``)."""
