"""Data: the device prefetcher and an in-memory dataset builder."""
