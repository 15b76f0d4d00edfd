"""Training of the port: the reference's ``train/`` (step factories and the
fault-tolerant loop), eager PyTorch on one device."""
