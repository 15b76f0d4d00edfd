"""Flash-attention forward for prefill: plain version and Hopper kernel."""
