"""Vector math, bit-exact RNG, samplers and host transforms."""
