"""Checkpoints in the reference's on-disk format (counterpart of
repro/checkpoint)."""
