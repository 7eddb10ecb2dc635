"""Cross-rank collectives of the port on ``torch.distributed`` (port of
repro/dist/, the part data parallelism needs)."""
