"""LM serving of the port: paged-KV decode over a block pool."""
