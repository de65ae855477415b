"""Evaluation: LPIPS, geometry primitives, the DTU and TnT protocols."""
