"""CTR backbones of the port (DCN)."""
