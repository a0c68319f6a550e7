"""Launchers (port in progress): the serving CLI."""
