"""Per-bank QoS arbitration comparator tree: plain version and Hopper kernel."""
