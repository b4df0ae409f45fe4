"""Channel and codec ops of the port; tables.py holds the constants."""
