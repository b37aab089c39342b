"""The wavefront integrator."""
