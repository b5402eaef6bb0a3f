"""Frames over several devices: screen bands and frame batches."""
