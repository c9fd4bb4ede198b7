"""Core engine: delta buffers, partitioning, fixpoint, executor."""
