"""Roofline analysis of the port, with the H100's peaks."""
