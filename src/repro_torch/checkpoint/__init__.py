"""Checkpoint save / restore of the port (.npz + manifest)."""
