"""Path simulators: GBM and Heston (full-truncation Euler)."""
