"""Roofline analysis of the dry run: three per-device terms (compute, HBM,
collectives) at one NVIDIA H100's constants, and the report CLI."""
