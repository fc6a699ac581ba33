"""Data layer: the retrieval pool, batched inference, piece sources."""
