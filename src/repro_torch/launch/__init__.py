"""Launchers: the serving CLI, the closed loop of controller and split
serving, the fleet simulation CLI and its markdown renderer, the
quickstart and fleet-simulation examples, the obs-trace and
flight-recorder viewers, and the decode profile."""
