"""Launchers (port in progress): the serving CLI, the closed loop of
controller and split serving, the fleet simulation CLI, the obs-trace and
flight-recorder viewers, and the decode profile."""
