"""Core math of the port: code containers, quantization, LPT tables."""
