"""Runtime helpers: logical-axis sharding on a device mesh."""
