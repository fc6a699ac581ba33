"""Device-side input preparation."""
