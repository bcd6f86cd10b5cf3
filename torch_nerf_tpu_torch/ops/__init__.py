"""Sampling, compositing and the fused field kernel."""
