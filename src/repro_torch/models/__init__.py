"""Models of the port: the CTR backbones (DCN, DeepFM), the LM transformer."""
