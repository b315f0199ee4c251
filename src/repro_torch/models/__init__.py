"""Models: the dense family of `repro/models/` (layers, RoPE, attention,
blocks, model assembly)."""
