"""Batched serving on the banked KV pool."""
