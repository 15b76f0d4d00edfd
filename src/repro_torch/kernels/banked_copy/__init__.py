"""Banked burst scatter into the KV pool: plain version and Hopper kernel."""
