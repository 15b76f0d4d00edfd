"""The multi-device layer of the port (``sharding``)."""
