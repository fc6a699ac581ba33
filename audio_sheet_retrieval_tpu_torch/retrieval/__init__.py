"""Retrieval services: embedding wrapper, gallery, piece-ID server."""
