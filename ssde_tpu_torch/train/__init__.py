"""Inference-side parts of ``ssde_tpu.train`` (model construction)."""
