"""Checkpoints: the reference's on-disk layout, with async save."""
