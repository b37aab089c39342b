"""Microbenchmarks of the card's mechanisms, each with a hand-written kernel."""
