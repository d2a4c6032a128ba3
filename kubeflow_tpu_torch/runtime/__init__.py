"""Analytic roofline for NVIDIA cards."""
