"""Real-time CC: `rtcc` (the ODE right-hand side and its observables),
the integrators, the laser envelopes and the spectral utilities."""
