"""Console and IO utilities."""
