"""Launchers: the serving CLI and batched serving across families
(``serve_batch``), the dev loop over every arch (``dev_smoke``), the closed
loop of controller and split serving, the fleet simulation CLI and its
markdown renderer, the quickstart and fleet-simulation examples, the
obs-trace and flight-recorder viewers, and the decode profile."""
