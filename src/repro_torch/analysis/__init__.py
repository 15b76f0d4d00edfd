"""Analytic cost models of the port (``costs``)."""
