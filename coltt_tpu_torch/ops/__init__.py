"""Primitives: quantization, distances, scores, top-k and the fused scan kernel."""
