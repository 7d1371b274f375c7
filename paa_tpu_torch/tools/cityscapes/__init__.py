"""Cityscapes tools of the port (port of tools/cityscapes/)."""
