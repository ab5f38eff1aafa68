"""Param-tree and checkpoint utilities."""
