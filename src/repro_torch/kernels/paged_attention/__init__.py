"""Paged decode attention over the KV pool: plain version and Hopper kernel."""
