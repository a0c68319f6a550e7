"""Device power parameters (paper Eqs. 1-3) + UAV kinetic power model [12];
port of ``repro.core.energy``.

The per-request compute/transmit energy formulas live in
``repro_torch.core.pricing`` and are re-exported here; ``kinetic_power``
stays local because it is a per-slot airframe term, not part of request
pricing.

Kinetic coefficients follow Stolaroff et al., "Energy use and life cycle
greenhouse gas emissions of drones for commercial package delivery"
(Nature Comm. 2018), scaled to the Aurelia X4 Standard class quadrotor the
paper simulates. Compute/transmit constants follow the Jetson TX2 + USRP
WiFi/LTE testbed regime.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.pricing import compute_energy, transmit_energy

__all__ = ["DevicePower", "kinetic_power", "compute_energy",
           "transmit_energy"]


@dataclasses.dataclass(frozen=True)
class DevicePower:
    # kinetic power draw (W) per activity [12], Aurelia X4-class
    p_forward: float = 210.0
    p_vertical: float = 305.0
    p_rotate: float = 175.0
    p_hover: float = 165.0
    # computation (Jetson TX2 under DNN load)
    p_compute: float = 10.0
    # radio transmit power bounds (USRP B210 WiFi/LTE)
    p_tx_min: float = 0.5
    p_tx_max: float = 2.0
    # battery (Aurelia X4 ~ 710 Wh full; mission share keeps episodes short)
    battery_wh: float = 90.0

    @property
    def battery_j(self) -> float:
        return self.battery_wh * 3600.0


def kinetic_power(p: DevicePower, fwd, vert, rot):
    """Average kinetic power (W) for an activity mix over the slot.
    fwd/vert/rot are fractions (tensors); the remainder hovers."""
    hover = torch.clip(1.0 - fwd - vert - rot, 0.0, 1.0)
    return (fwd * p.p_forward + vert * p.p_vertical + rot * p.p_rotate
            + hover * p.p_hover)
