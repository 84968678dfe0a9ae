"""Plant models."""
