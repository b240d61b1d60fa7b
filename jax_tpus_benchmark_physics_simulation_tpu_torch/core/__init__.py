"""Typed configs and state containers."""
