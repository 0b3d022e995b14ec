"""Models of the port: the AR1 multi-fidelity GP's functional core."""
