"""Inference surfaces of the port: ``serving`` (the paged-KV serving
engine)."""
