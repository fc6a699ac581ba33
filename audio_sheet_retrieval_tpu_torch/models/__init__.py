"""Model core: encoders, CCA head, checkpoint import."""
