"""Channel models for loopback tests and simulation."""
