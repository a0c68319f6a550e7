"""Launchers (port in progress): the serving CLI, the closed loop of
controller and split serving, and the decode profile."""
