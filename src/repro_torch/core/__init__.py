"""The port's cycle-level fabric simulator."""
