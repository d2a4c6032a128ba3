"""Decoder, quantized layers, weight conversion and generation."""
