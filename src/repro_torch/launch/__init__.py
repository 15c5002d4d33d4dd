"""Launchers: the analytics device mesh."""
